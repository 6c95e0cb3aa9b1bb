"""Port parity: the knowledge graph, the search tuner and the engine's KG leg.

- Database and KnowledgeGraphStore (yams_tpu_torch.metadata): the same writes
  made by either package give equal public reads, and a SQLite file written
  by either package reads the same through the other's store.
- SearchTuner (yams_tpu_torch.search.tuner): the same feedback sequence gives
  the same arms, and a state file written by either package loads in the
  other.
- The engine with a KG: a yams_tpu SearchEngine(kg_store=...) and a port
  engine that got its state through convert (entity side index and tuner
  statistics included), each over its own store on one SQLite file, built
  with the calls the graph service makes on ingest: the same top-10 ids and
  scores within 1e-4 with the graph rerank on and off, semantic rescue, the
  tuner after the same feedback (the same arm chosen), and a cross
  reranker; `_community_support` on hand-built windows.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from yams_tpu.metadata.db import Database as RefDatabase
from yams_tpu.metadata.kg import KnowledgeGraphStore as RefKG
from yams_tpu.search.config import SearchEngineConfig as RefConfig
from yams_tpu.search.engine import SearchEngine as RefEngine
from yams_tpu.search.tuner import SearchTuner as RefTuner
from yams_tpu.search.tuner import corpus_profile as ref_profile
from yams_tpu_torch.convert import load_state, state_from_jax
from yams_tpu_torch.metadata import Database, KnowledgeGraphStore
from yams_tpu_torch.scripts.kg_fixture import build_kg, one_transaction
from yams_tpu_torch.search.config import SearchEngineConfig
from yams_tpu_torch.search.engine import SearchEngine
from yams_tpu_torch.search.tuner import SearchTuner, corpus_profile

CPU = torch.device("cpu")
WORDS = [f"term{i}" for i in range(300)] + [
    "scheduler", "thread", "preempt", "memory", "chunk", "hash", "index",
    "query", "routing", "compression", "snapshot", "raft", "quorum"]


def _insert_docs(db, doc_ids):
    """`documents` rows for the doc ids (doc_entities references them)."""
    with db.lock, db.conn:
        db.conn.executemany(
            "INSERT INTO documents (id, file_path, file_name, sha256_hash,"
            " created_time, modified_time, indexed_time) VALUES (?,?,?,?,0,0,0)",
            [(d, f"/doc/{d}", f"{d}.txt", f"{d:064d}") for d in doc_ids])


def _kg_corpus(n_docs=240, n_nodes=48, seed=0):
    rng = np.random.default_rng(seed)

    def words(a, size):
        return " ".join(WORDS[z % len(WORDS)] for z in rng.zipf(a, size=size))

    docs = [(1000 + i, words(1.3, int(rng.integers(8, 40))) + ".", words(1.5, 3))
            for i in range(n_docs)]
    labels = list(dict.fromkeys(words(1.2, int(rng.integers(1, 4))) for _ in range(4 * n_nodes)))
    labels = labels[:n_nodes]
    doc_links = []
    for d, _, _ in docs:
        ents = (rng.zipf(1.5, size=int(rng.integers(1, 6))) - 1) % len(labels)
        ents = list(dict.fromkeys(int(e) for e in ents))
        doc_links.append((d, [(e, float(rng.uniform(0.4, 1.0))) for e in ents]))
    queries = [labels[int(rng.integers(len(labels)))] if i % 2 else words(1.3, 3)
               for i in range(24)]
    return docs, labels, doc_links, queries


@pytest.fixture(scope="module")
def kg_engines(tmp_path_factory):
    """A reference engine with a KG on one SQLite file, and the port's own
    store over the same file."""
    docs, labels, doc_links, queries = _kg_corpus()
    path = tmp_path_factory.mktemp("kg") / "m.db"
    ref_db = RefDatabase(path)
    _insert_docs(ref_db, [d for d, _, _ in docs])
    ref_kg = RefKG(ref_db)
    ref = RefEngine(RefConfig(), kg_store=ref_kg)
    ref.add_documents(docs)
    nodes, _ = build_kg(ref_kg, labels, doc_links)   # the graph service's calls
    ref.add_entity_vectors(nodes, labels)
    port_kg = KnowledgeGraphStore(Database(path))
    return ref, port_kg, queries


def _port_of(ref, port_kg, **change):
    """A port engine on the reference's state, with a tuner where it has one."""
    port = SearchEngine(SearchEngineConfig(**change), kg_store=port_kg, device=CPU)
    if ref.tuner is not None:
        port.tuner = SearchTuner()
    load_state(port, state_from_jax(ref))
    return port


def _same(ref_results, port_results, atol=1e-4):
    for r, p in zip(ref_results, port_results, strict=True):
        assert [x.doc_id for x in p] == [x.doc_id for x in r]
        np.testing.assert_allclose([x.score for x in p], [x.score for x in r],
                                   atol=atol, rtol=0)
        np.testing.assert_allclose([x.kg_score for x in p], [x.kg_score for x in r],
                                   atol=atol, rtol=0)


@pytest.fixture
def ref_config(kg_engines):
    """The reference engine's config, restored after the test."""
    ref = kg_engines[0]
    saved = ref.config
    yield ref
    ref.config = saved


def _rerank_by_title_length(query, results):
    return sorted(results, key=lambda r: (len(r.title), r.doc_id))


@pytest.mark.parametrize("case", ["graph_rerank", "no_graph_rerank", "rescue",
                                  "cross_reranker"])
def test_kg_engine_matches_reference(kg_engines, ref_config, case):
    ref, port_kg, queries = kg_engines
    change = {"no_graph_rerank": {"graph_rerank_enabled": False},
              "rescue": {"semantic_rescue_slots": 2}}.get(case, {})
    ref.config = RefConfig(**change)
    port = _port_of(ref, port_kg, **change)
    if case == "cross_reranker":
        ref.cross_reranker = port.cross_reranker = _rerank_by_title_length
    try:
        want = ref.search_batch(queries, k=10)
        got = port.search_batch(queries, k=10)
    finally:
        ref.cross_reranker = None
    _same(want, got)
    assert sum(any(r.kg_score > 0 for r in res) for res in got) >= len(queries) // 2
    if case == "rescue":
        k = 3
        _same(ref.search_batch(queries, k=k), port.search_batch(queries, k=k))
    for mode in ("keyword", "vector"):
        _same(ref.search_batch(queries[:6], mode=mode), port.search_batch(queries[:6], mode=mode))


def test_entity_leg_matches_reference(kg_engines):
    """The entity side index carried by convert gives the same hits."""
    ref, port_kg, queries = kg_engines
    port = _port_of(ref, port_kg)
    assert np.array_equal(port.entity_index._vecs, ref.entity_index._vecs)
    assert port.entity_index.capacity == ref.entity_index.capacity
    want = ref._entity_vector_batch(queries)
    got = port._entity_vector_batch(queries)
    assert [[n for n, _ in h] for h in got] == [[n for n, _ in h] for h in want]
    np.testing.assert_allclose([s for h in got for _, s in h],
                               [s for h in want for _, s in h], atol=1e-5, rtol=0)
    assert sum(map(len, got)) > 0
    for q, hits in zip(queries, want):
        assert port._kg_scores(q, hits) == ref._kg_scores(q, hits)


def test_tuner_engine_matches_reference(kg_engines, ref_config):
    """The same 32 feedback calls on both engines: the same arms chosen and
    the same results; the statistics carried by convert agree."""
    ref, port_kg, queries = kg_engines
    ref.config = RefConfig(tuner_enabled=True)
    port = _port_of(ref, port_kg, tuner_enabled=True)
    ref.tuner, port.tuner = RefTuner(), SearchTuner()
    try:
        for i in range(32):
            batch = queries[i % 4 * 4:][:4]
            want, got = ref.search_batch(batch), port.search_batch(batch)
            assert port.last_trace["tuner_arm"] == ref.last_trace["tuner_arm"]
            _same(want, got)
            doc = want[0][i % len(want[0])].doc_id
            ref.record_feedback(doc, relevant=i % 3 != 0)
            port.record_feedback(doc, relevant=i % 3 != 0)
        assert port.tuner._stats == ref.tuner._stats
        carried = _port_of(ref, port_kg, tuner_enabled=True)
        assert carried.tuner._stats == ref.tuner._stats
        assert carried.tuner._last_arm == ref.tuner._last_arm
        assert carried.search_batch(queries[:4])[0][0].doc_id == \
            ref.search_batch(queries[:4])[0][0].doc_id
    finally:
        ref.tuner = None
        ref.clear_hot()


_WINDOWS = {
    "single": [1000],
    "unlinked": [999_999, 999_998, 1000],
    "first25": list(range(1000, 1025)),
    "spread": list(range(1000, 1240, 9)),
    "duplicates": [1000, 1001, 1000, 1002, 1001],
}


@pytest.mark.parametrize("window", sorted(_WINDOWS))
@pytest.mark.parametrize("change", [{}, {"graph_max_neighbors": 2},
                                    {"graph_community_min_edge_weight": 1.2,
                                     "graph_community_reference_size": 1.0}])
def test_community_support_matches_reference(kg_engines, ref_config, window, change):
    ref, port_kg, _ = kg_engines
    ref.config = RefConfig(**change)
    port = SearchEngine(SearchEngineConfig(**change), kg_store=port_kg, device=CPU)
    got = port._community_support(_WINDOWS[window])
    assert got == ref._community_support(_WINDOWS[window])
    if window in ("first25", "spread") and not change:
        assert any(s > 0 for s in got)


# -- the stores -------------------------------------------------------------------
def _write_kg(db_cls, kg_cls, path):
    db = db_cls(path)
    _insert_docs(db, [1, 2, 3, 4])
    kg = kg_cls(db)
    a = kg.upsert_node("entity:raft", label="Raft")
    b = kg.upsert_node("entity:quorum", label="Quorum", properties={"k": 1})
    c = kg.upsert_node("entity:raft", label="")           # keeps the label
    assert c == a
    kg.add_alias(a, "raft", source="mined")
    kg.add_alias(a, "raft consensus")
    kg.add_alias(b, "quorum")
    kg.add_edge(a, b, "cooccurs", 0.5)
    kg.add_edge(a, b, "cooccurs", 0.9)                     # keeps the max weight
    kg.add_edges_batch([(a, b, "related", 0.3), (b, a, "cooccurs", 0.2)])
    kg.link_document(1, a, "Raft", 0.9)
    kg.link_document(1, b, "Quorum", 0.6)
    kg.link_document(2, a, "raft", 0.4)
    kg.link_document(3, b, "quorum", 0.7)
    db.close()


def _reads(db_cls, kg_cls, path):
    db = db_cls(path)
    kg = kg_cls(db)
    nodes = [kg.get_node(i) for i in range(1, 4)]
    out = {
        "nodes": nodes,
        "find": [kg.find_node("entity:raft"), kg.find_node("entity:none")],
        "counts": [kg.node_count(), kg.edge_count()],
        "alias": [kg.resolve_alias(a) for a in ("raft", "raf", "quorum", "zzz")],
        "alias_again": kg.resolve_alias("raft"),          # the cached read
        "neighbors": [kg.neighbors(n) for n in (1, 2)] + [kg.neighbors(1, "related")],
        "docs": [kg.documents_for_node(n) for n in (1, 2)],
        "ents": [kg.entities_for_document(d) for d in (1, 2, 4)],
        "ents_batch": kg.entities_for_documents([1, 2, 3, 4, 1]),
        "has": kg.has_doc_entities(),
        "related": [kg.related_documents(d, hops=h) for d in (1, 3) for h in (1, 2)],
        "schema": [tuple(r) for r in db.execute(
            "SELECT name, sql FROM sqlite_master ORDER BY name").fetchall()],
        "versions": [r[0] for r in db.execute(
            "SELECT version FROM schema_version ORDER BY version").fetchall()],
        "integrity": db.integrity_check(),
        "journal": db.execute("PRAGMA journal_mode").fetchone()[0],
    }
    db.close()
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_kg_store_reads_equal_across_packages(tmp_path, writer):
    """Each package writes its own file with the same calls; the file each
    wrote reads the same through both packages' stores, and equal to the
    other's file."""
    pkgs = {"reference": (RefDatabase, RefKG), "port": (Database, KnowledgeGraphStore)}
    for name, (db_cls, kg_cls) in pkgs.items():
        _write_kg(db_cls, kg_cls, tmp_path / f"{name}.db")
    path = tmp_path / f"{writer}.db"
    reads = [_reads(db_cls, kg_cls, path) for db_cls, kg_cls in pkgs.values()]
    assert reads[0] == reads[1]
    other = "port" if writer == "reference" else "reference"
    assert reads[0] == _reads(*pkgs[writer], tmp_path / f"{other}.db")
    assert reads[0]["journal"] == "wal" and reads[0]["versions"][-1] == 7


def test_kg_caches_follow_writes(tmp_path):
    """A write bumps the generation: cached alias and doc reads refresh in
    both stores, each on its own connection to one file."""
    path = tmp_path / "m.db"
    _write_kg(Database, KnowledgeGraphStore, path)
    port, ref = KnowledgeGraphStore(Database(path)), RefKG(RefDatabase(path))
    assert port.resolve_alias("quorum") == ref.resolve_alias("quorum") == [2]
    port.add_alias(1, "quorum")
    assert sorted(port.resolve_alias("quorum")) == [1, 2]
    ref._bump()
    assert sorted(ref.resolve_alias("quorum")) == [1, 2]
    ref.link_document(4, 1, "raft", 0.8)
    port._bump()
    assert port.documents_for_node(1) == ref.documents_for_node(1)
    assert (4, 0.8) in port.documents_for_node(1)


def _kg_rows(path):
    """Every KG row of a file but the nodes' creation times."""
    db = Database(path)
    out = {table: sorted(tuple(r) for r in db.execute(f"SELECT {cols} FROM {table}"))
           for table, cols in (("kg_nodes", "id, node_key, label, type, properties"),
                               ("kg_aliases", "node_id, alias, source"),
                               ("kg_edges", "src_node_id, dst_node_id, relation, weight"),
                               ("doc_entities", "document_id, node_id, entity_text, confidence"))}
    db.close()
    return out


def test_one_transaction_writes_what_the_calls_commit(tmp_path):
    """The graph service's calls joined into one transaction write the rows
    that the same calls write committing one at a time."""
    docs, labels, links, _ = _kg_corpus(n_docs=60, n_nodes=20)
    built = {}
    for name in ("one_a_call", "joined"):
        db = Database(tmp_path / f"{name}.db")
        _insert_docs(db, [d for d, _, _ in docs])
        if name == "joined":
            with one_transaction(db) as kg:
                built[name] = build_kg(kg, labels, links)
        else:
            built[name] = build_kg(KnowledgeGraphStore(db), labels, links)
        db.close()
    assert built["joined"] == built["one_a_call"]
    assert built["joined"][1] > 2 * len(labels)
    rows = _kg_rows(tmp_path / "joined.db")
    assert rows == _kg_rows(tmp_path / "one_a_call.db") and rows["doc_entities"]


def test_one_transaction_rolls_back_when_it_raises(tmp_path):
    db = Database(tmp_path / "m.db")
    _insert_docs(db, [1])
    with pytest.raises(RuntimeError, match="stop"):
        with one_transaction(db) as kg:
            node = kg.upsert_node("entity:raft", label="Raft")
            kg.link_document(1, node, "Raft", 0.9)
            raise RuntimeError("stop")
    kg = KnowledgeGraphStore(db)
    assert kg.node_count() == 0 and not kg.has_doc_entities()


def test_load_state_needs_a_tuner_for_tuner_statistics(kg_engines):
    """A state with tuner statistics loads only into an engine given a tuner:
    load_state never turns the tuner on by itself."""
    ref, port_kg, _ = kg_engines
    ref.tuner = RefTuner()
    try:
        state = state_from_jax(ref)
    finally:
        ref.tuner = None
    port = SearchEngine(kg_store=port_kg, device=CPU)
    with pytest.raises(ValueError, match="tuner"):
        load_state(port, state)
    assert port.tuner is None and not port._doc_by_slot
    port.tuner = SearchTuner()
    load_state(port, state)
    assert port.tuner._stats == {} and port._doc_by_slot == ref._doc_by_slot


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tuner_matches_reference(tmp_path, writer):
    """The same rewards pick the same arms; the state file either package
    writes loads in the other and picks on from there alike."""
    state = tmp_path / "tuner.json"
    tuners = {"reference": RefTuner(state_path=state if writer == "reference" else None),
              "port": SearchTuner(state_path=state if writer == "port" else None)}
    rng = np.random.default_rng(3)
    for step in range(60):
        profile = ["small", "medium", "large"][step % 3]
        picks = [t.select(profile) for t in tuners.values()]
        assert picks[0][0] == picks[1][0] and picks[0][1].name == picks[1][1].name
        reward = float(rng.uniform(-0.2, 1.2))
        for t in tuners.values():
            t.record_reward(reward, profile=profile)
    assert tuners["port"].snapshot() == tuners["reference"].snapshot()
    assert json.loads(state.read_text()) == tuners[writer]._stats
    reloaded = [RefTuner(state_path=state), SearchTuner(state_path=state)]
    assert reloaded[0]._stats == reloaded[1]._stats == tuners[writer]._stats
    for profile in ("small", "medium", "large", "new"):
        assert reloaded[0].select(profile)[0] == reloaded[1].select(profile)[0]
    cfg, ref_cfg = SearchEngineConfig(), RefConfig()
    for t_arm, r_arm in zip(tuners["port"].arms, tuners["reference"].arms):
        assert dataclasses.asdict(t_arm.apply(cfg)) == dataclasses.asdict(r_arm.apply(ref_cfg))
    for n in (0, 999, 1000, 99_999, 100_000):
        assert corpus_profile(n) == ref_profile(n)
