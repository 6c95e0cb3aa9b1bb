"""Port parity for the add -> search slice as a whole.

- Simeon embeddings: the port's projection and encode are bit-equal to
  yams_tpu's (same NumPy Philox draw, same RNE bf16 rounding, same sgemm).
- Search: a yams_tpu SearchEngine and a port SearchEngine get the same
  documents (directly, and through convert.state_from_jax/load_state); top-10
  ids must agree on at least 95% of the queries and fused scores to 1e-4 (the
  fusion's adaptive leg weights amplify ulp-level reduction-order differences,
  see tests/test_torch_fusion.py).
- Add: the port's ContentStore device tier, forced on the CPU, writes the same
  manifest as the reference's host path; a payload it declines goes to the
  port's own host tiers, and no yams_tpu module is loaded.
- PQ tier: the reference's TestPQTier scenarios (tests/test_engine_scale.py)
  on a yams_tpu engine and on a port engine that got its state, codebook
  included, through convert: the same top-k ids.
- The int8 tier with every chunk aggregation; the streaming tier, forced on
  a flat corpus by lowered thresholds, unfiltered and filtered;
  remove_document (which ends the identity layout, and so streaming); the
  hotzone and feedback; each intent; search_expanded; stats: each on a
  yams_tpu engine and a port engine fed the same documents.
- No reference: the slice runs in a fresh interpreter without importing jax
  or any module of yams_tpu.
"""

import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from yams_tpu.core.config import (ChunkingConfig, EmbeddingConfig, LexicalIndexConfig,
                                  VectorIndexConfig)
from yams_tpu.embed.simeon import SimeonEncoder
from yams_tpu.search.config import SearchEngineConfig as RefConfig
from yams_tpu.search.engine import SearchEngine as RefEngine
from yams_tpu_torch.convert import load_state, state_from_jax
from yams_tpu_torch.embed.provider import SimeonProvider, projection_host
from yams_tpu_torch.search.config import SearchEngineConfig
from yams_tpu_torch.search.engine import SearchEngine

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent
WORDS = [f"term{i}" for i in range(500)] + [
    "scheduler", "thread", "preempt", "memory", "chunk", "hash", "index",
    "query", "routing", "routed", "compression", "snapshot"]


def _corpus(n_docs=300, n_queries=20, seed=0):
    rng = np.random.default_rng(seed)

    def words(a, size):
        return " ".join(WORDS[z % len(WORDS)] for z in rng.zipf(a, size=size))

    docs = [(1000 + i, words(1.3, int(rng.integers(8, 40))) + ".",
             words(1.5, 3)) for i in range(n_docs)]
    queries = [words(1.3, int(rng.integers(1, 5))) for _ in range(n_queries)]
    return docs, queries


@pytest.fixture(scope="module")
def engines():
    docs, queries = _corpus()
    ref = RefEngine()
    ref.add_documents(docs)
    return ref, docs, queries


def test_search_config_is_the_reference_dataclass():
    port, ref = SearchEngineConfig(), RefConfig()
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_projection_and_encode_bit_equal():
    cfg = EmbeddingConfig()
    enc = SimeonEncoder(cfg)
    assert np.array_equal(projection_host(cfg).view(np.uint32),
                          enc._R_host().view(np.uint32))
    docs, queries = _corpus(40, 10, seed=1)
    texts = [d[1] for d in docs] + queries + ["ünïcödé routing", ""]
    got = SimeonProvider(cfg, device=CPU).encode(texts)
    assert np.array_equal(got.view(np.uint32), enc.encode(texts).view(np.uint32))


def _compare(ref_results, port_results, min_equal=0.95, atol=1e-4):
    same = 0
    for r, p in zip(ref_results, port_results):
        ri, pi = [x.doc_id for x in r], [x.doc_id for x in p]
        if ri == pi:
            same += 1
            np.testing.assert_allclose([x.score for x in p], [x.score for x in r],
                                       atol=atol, rtol=0)
    assert same >= min_equal * len(ref_results), (same, len(ref_results))


def test_engine_matches_reference_through_convert(engines):
    ref, docs, queries = engines
    port = SearchEngine(device=CPU)
    load_state(port, state_from_jax(ref))
    _compare(ref.search_batch(queries), port.search_batch(queries))
    for mode in ("keyword", "vector"):
        _compare(ref.search_batch(queries[:8], mode=mode),
                 port.search_batch(queries[:8], mode=mode))


def test_engine_matches_reference_after_direct_adds(engines):
    ref, docs, queries = engines
    port = SearchEngine(device=CPU)
    port.add_documents(docs)
    assert np.array_equal(port.vector_index._vecs, ref.vector_index._vecs)
    assert port.lexical_index._vocab == ref.lexical_index._vocab
    filt = {d[0] for d in docs[::3]}
    _compare(ref.search_batch(queries, filter_doc_ids=filt),
             port.search_batch(queries, filter_doc_ids=filt))
    per_q = [filt if i % 2 else None for i in range(len(queries))]
    _compare(ref.search_batch(queries, per_query_filters=per_q),
             port.search_batch(queries, per_query_filters=per_q))


@pytest.mark.parametrize("change", [
    {"topology_policy": "narrow"},
    {"tuner_enabled": True},
    {"semantic_rescue_slots": 2},
])
def test_unported_engine_paths_refuse(engines, change):
    """Narrow topology routing, the tuner and semantic rescue each refused
    until the port had them: each now matches the reference on the same adds
    (narrow over a topology built on both engines after the same number of
    searches, so with the same k-means seed; the tuner after the same
    feedback, with the same arm chosen). Both run the CSR lexical leg: the
    packed leg's BM25 sums drift a few ulps from the reference's, which
    reorders near-tied docs, and the RRF term of the arms that weight it
    more (vector_heavy, rrf_heavy) turns one rank into ~6e-4 of fused
    score."""
    _, docs, queries = engines
    from yams_tpu_torch.core.config import LexicalIndexConfig as PortLexical
    port = SearchEngine(SearchEngineConfig(**change), lexical=PortLexical(packed_max_entries=0),
                        device=CPU)
    port.add_documents(docs[:20])
    from yams_tpu.search.tuner import SearchTuner as RefTuner
    from yams_tpu_torch.search.tuner import SearchTuner
    ref = RefEngine(RefConfig(**change), lexical=LexicalIndexConfig(packed_max_entries=0))
    ref.add_documents(docs[:20])
    if "topology_policy" in change:
        ref.rebuild_topology()
        port.rebuild_topology()
        assert np.array_equal(port.topology.artifacts.assignments,
                              ref.topology.artifacts.assignments)
    if "tuner_enabled" in change:
        ref.tuner, port.tuner = RefTuner(), SearchTuner()
        for i in range(10):
            want, got = ref.search_batch(queries[:4]), port.search_batch(queries[:4])
            assert port.last_trace["tuner_arm"] == ref.last_trace["tuner_arm"]
            _compare(want, got, min_equal=1.0)
            ref.record_feedback(docs[i][0], relevant=i % 2 == 0)
            port.record_feedback(docs[i][0], relevant=i % 2 == 0)
        assert port.tuner._stats == ref.tuner._stats
    for k in (3, 10):
        _compare(ref.search_batch(queries, k=k), port.search_batch(queries, k=k))


def test_content_store_device_tier_matches_reference_host_path(tmp_path, monkeypatch):
    from yams_tpu.storage.content_store import ContentStore as RefStore
    from yams_tpu_torch.storage.content_store import ContentStore

    chunking = ChunkingConfig(min_size=256, avg_size=1024, max_size=4096)
    data = np.random.default_rng(9).bytes(40_000)
    monkeypatch.delenv("YAMS_DEVICE_INGEST", raising=False)
    ref = RefStore(tmp_path / "ref", chunking=chunking)
    want = ref.store_bytes(data)
    want_manifest = ref.refcounter.get_manifest(want.content_hash)
    monkeypatch.setenv("YAMS_DEVICE_INGEST", "1")
    port = ContentStore(tmp_path / "port", chunking=chunking, device="cpu")
    got = port.store_bytes(data)
    assert got.phase_timings_ms.get("device_tier") == 1.0
    assert port.refcounter.get_manifest(got.content_hash).to_dict() == \
        want_manifest.to_dict()
    assert port.retrieve_bytes(got.content_hash) == data
    again = port.store_bytes(data)                 # whole-content dedup
    assert again.content_hash == got.content_hash and again.bytes_stored == 0
    ref.close()
    port.close()


def _run_fresh(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_slice_runs_without_jax():
    out = _run_fresh("""
        import sys
        import torch
        from yams_tpu_torch.ingest.device_pipeline import device_chunk_hash
        from yams_tpu_torch.search.engine import SearchEngine
        cpu = torch.device("cpu")
        trip = device_chunk_hash(bytes(range(256)) * 64, 256, 1024, 4096, cpu)
        assert trip[-1][2] == 256 * 64
        eng = SearchEngine(device=cpu)
        eng.add_documents([(1, "thread scheduler preempts", "sched"),
                           (2, "chunk hashing and dedup", "cas")])
        hits = eng.search_batch(["scheduler", "dedup chunk"])
        assert hits[0][0].doc_id == 1 and hits[1][0].doc_id == 2
        print("jax" in sys.modules)
    """)
    assert out.strip() == "False"


def test_small_store_goes_to_parent_without_jax(tmp_path):
    out = _run_fresh(f"""
        import os, sys
        os.environ.pop("YAMS_DEVICE_INGEST", None)
        from yams_tpu_torch.storage.content_store import ContentStore
        cs = ContentStore({str(tmp_path)!r}, device="cpu")
        res = cs.store_bytes(b"small payload " * 100)
        assert "device_tier" not in res.phase_timings_ms
        cs.close()
        print("jax" in sys.modules)
    """)
    assert out.strip() == "False"


REFERENCE_ROOTS = ("yams_tpu", "jax", "jaxlib", "flax")
LOADED = ("sorted(m for m in sys.modules if m.split('.')[0] in "
          f"{REFERENCE_ROOTS!r})")


def test_large_cpu_store_skips_reference_device_tier(tmp_path):
    """A payload at the device threshold that the port declines (its device
    is the CPU) reaches the port's own host tiers, and no module of
    yams_tpu, jax, jaxlib or flax is loaded. The threshold is lowered to
    64 KiB to keep the payload small."""
    out = _run_fresh(f"""
        import os, sys
        os.environ.pop("YAMS_DEVICE_INGEST", None)
        os.environ["YAMS_DEVICE_INGEST_MIN"] = "65536"
        import numpy as np
        from yams_tpu_torch.ingest.device_pipeline import DEVICE_MIN_BYTES
        from yams_tpu_torch.storage.content_store import ContentStore
        data = np.random.default_rng(3).bytes(DEVICE_MIN_BYTES + 1)
        cs = ContentStore({str(tmp_path)!r}, device="cpu")
        res = cs.store_bytes(data)
        assert "device_tier" not in res.phase_timings_ms
        assert cs.retrieve_bytes(res.content_hash) == data
        cs.close()
        print({LOADED})
    """)
    assert out.strip() == "[]"


def test_chip_smoke_imports_only_the_port():
    """The card's smoke, every phase of it, imports only yams_tpu_torch,
    torch, numpy and the standard library, directly; importing it, and the
    port modules its phases import, loads no module of yams_tpu, jax,
    jaxlib or flax."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots, port_modules = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
            if node.module.startswith("yams_tpu_torch"):
                port_modules.add(node.module)
    assert "yams_tpu_torch" in roots
    assert not roots & set(REFERENCE_ROOTS), roots
    others = roots - {"yams_tpu_torch", "torch", "numpy", "__future__"}
    assert others <= set(sys.stdlib_module_names), others
    out = _run_fresh(f"""
        import importlib, sys
        import chip_smoke
        for name in {sorted(port_modules)!r}:
            importlib.import_module(name)
        print({LOADED})
    """)
    assert out.strip() == "[]"


def test_declined_store_leaves_reference_state_alone(tmp_path):
    """A port store on the CPU takes a small payload, then one just above the
    device threshold (lowered to 64 KiB): both go to the port's host tiers,
    and no module of yams_tpu (whose device tier keeps module state), jax,
    jaxlib or flax is ever loaded."""
    out = _run_fresh(f"""
        import os, sys
        os.environ.pop("YAMS_DEVICE_INGEST", None)
        os.environ["YAMS_DEVICE_INGEST_MIN"] = "65536"
        import numpy as np
        from yams_tpu_torch.ingest.device_pipeline import DEVICE_MIN_BYTES
        from yams_tpu_torch.storage.content_store import ContentStore
        cs = ContentStore({str(tmp_path)!r}, device="cpu")
        rng = np.random.default_rng(4)
        for n in (5_000, DEVICE_MIN_BYTES + 1):
            data = rng.bytes(n)
            res = cs.store_bytes(data)
            assert "device_tier" not in res.phase_timings_ms
            assert cs.retrieve_bytes(res.content_hash) == data
        cs.close()
        print({LOADED})
    """)
    assert out.strip() == "[]"


# -- PQ capacity tier ------------------------------------------------------------
def _pq_configs(capacity: int = 256, **cfg):
    return dict(config=RefConfig(batch_pad=4, **cfg),
                embedding=EmbeddingConfig(dim=64, sketch_dim=512),
                vector=VectorIndexConfig(dim=64, capacity=capacity, block_rows=128),
                lexical=LexicalIndexConfig(postings_window=64))


def _pq_engines(docs, build=True, capacity=256, rerank_factor=4, **cfg):
    """A yams_tpu engine with the PQ tier on (PQ4 built when `build`) and a
    port engine with its state."""
    cfg.setdefault("pq_tier_enabled", True)
    ref = RefEngine(**_pq_configs(capacity, **cfg))
    ref.add_documents(docs)
    if build:
        ref.vector_index.build_pq(m=16, ksub=16, pack4=True,
                                  rerank_factor=rerank_factor)
    kw = _pq_configs(capacity, **cfg)
    kw["config"] = SearchEngineConfig(**dataclasses.asdict(kw["config"]))
    port = SearchEngine(**kw, device=CPU)
    load_state(port, state_from_jax(ref))
    return ref, port


def _subject_docs(n=60):
    return [(i, f"doc {i} about subject {'pqr'[i % 3]}", "") for i in range(n)]


def _ids(results):
    return [[r.doc_id for r in q] for q in results]


PQ_QUERIES = ["subject p doc", "subject q", "doc subject r"]


@pytest.mark.parametrize("chunk_agg", ["max", "topk_avg"])
def test_pq_tier_matches_reference_and_is_close_to_dense(chunk_agg):
    ref, port = _pq_engines(_subject_docs(), chunk_agg=chunk_agg)
    assert port.vector_index.has_pq
    _compare(ref.search_batch(PQ_QUERIES, k=5), port.search_batch(PQ_QUERIES, k=5),
             min_equal=1.0)
    if chunk_agg == "max":
        _, dense = _pq_engines(_subject_docs(), build=False, pq_tier_enabled=False)
        for rp, rd in zip(_ids(port.search_batch(PQ_QUERIES, k=5)),
                          _ids(dense.search_batch(PQ_QUERIES, k=5))):
            assert len(set(rp) & set(rd)) >= 4, (rp, rd)


def test_pq_tier_never_uploads_dense_matrix():
    _, port = _pq_engines(_subject_docs())
    vi = port.vector_index
    vi._device = None
    vi.upload_bytes_total = 0
    assert port.search("subject p doc", k=5)
    assert vi._device is None
    assert vi.upload_bytes_total < vi.capacity * 64 * 2


def test_pq_tier_without_build_falls_back_to_dense():
    docs = [(i, f"note {i} theme {'xy'[i % 2]}", "") for i in range(20)]
    ref, port = _pq_engines(docs, build=False)
    assert not port.vector_index.has_pq
    _compare(ref.search_batch(["theme x"], k=3), port.search_batch(["theme x"], k=3),
             min_equal=1.0)


@pytest.mark.parametrize("mode", ["keyword", "vector"])
def test_pq_tier_modes(mode):
    ref, port = _pq_engines(_subject_docs())
    res = port.search_batch(PQ_QUERIES, k=5, mode=mode)
    _compare(ref.search_batch(PQ_QUERIES, k=5, mode=mode), res, min_equal=1.0)
    if mode == "keyword":
        assert res[0] and all(r.doc_id % 3 == 0 for r in res[0][:3])


def test_pq_tier_respects_doc_filter():
    ref, port = _pq_engines(_subject_docs())
    allow = {3, 6, 9}
    got = port.search_batch(PQ_QUERIES, k=5, filter_doc_ids=allow)
    _compare(ref.search_batch(PQ_QUERIES, k=5, filter_doc_ids=allow), got,
             min_equal=1.0)
    assert got[0] and all(r.doc_id in allow for q in got for r in q)
    per_q = [allow, None, {1, 2}]
    _compare(ref.search_batch(PQ_QUERIES, k=5, per_query_filters=per_q),
             port.search_batch(PQ_QUERIES, k=5, per_query_filters=per_q),
             min_equal=1.0)


def test_pq_tier_filter_pushdown_selective():
    """A selective filter still gets vector candidates: the mask is pushed
    into the ADC scan, so the 350 off-filter docs cannot fill the budget."""
    docs = ([(i, f"zebra quantum flux note {i}", "") for i in range(350)]
            + [(i, f"maple syrup harvest log {i}", "") for i in range(350, 400)])
    ref, port = _pq_engines(docs, capacity=512, rerank_factor=1)
    allow = {360, 370, 380}
    got = port.search("zebra quantum flux", k=5, mode="vector", filter_doc_ids=allow)
    assert got and all(r.doc_id in allow for r in got)
    _compare([ref.search("zebra quantum flux", k=5, mode="vector",
                         filter_doc_ids=allow)], [got], min_equal=1.0)


def test_ensure_pq_builds_the_configured_engine():
    docs = _subject_docs(80)
    cfg = SearchEngineConfig(batch_pad=4, pq_tier_enabled=True)
    port = SearchEngine(cfg, EmbeddingConfig(dim=64, sketch_dim=512),
                        VectorIndexConfig(dim=64, capacity=256, block_rows=128,
                                          engine="pq4", pq_min_rows=50, pq_m=16),
                        LexicalIndexConfig(postings_window=64), device=CPU)
    assert not port.ensure_pq()                    # no rows yet
    port.add_documents(docs)
    assert port.ensure_pq() and not port.ensure_pq()   # built; not doubled since
    vi = port.vector_index
    assert vi.has_pq and vi._pq_packed4 and vi._pq_group == 1
    assert vi._pq_codebook.ksub == 16 and vi._pq_built_rows == vi.active_rows
    assert port.search("subject p doc", k=5)
    with pytest.raises(NotImplementedError):
        SearchEngine(vector=VectorIndexConfig(engine="hnsw"), device=CPU)


# -- the int8 tier, the streaming tier and the engine surface ----------------------
def _pair(docs, dtype="bfloat16", capacity=2048, streaming=False, **cfg):
    """A yams_tpu engine and a port engine, each fed `docs` directly. With
    `streaming`, the thresholds are lowered (tests/test_engine_scale.py) so
    that a flat corpus takes the streaming tier."""
    if streaming:
        cfg.update(streaming_threshold=1, streaming_block_rows=128)
    kw = dict(embedding=EmbeddingConfig(dim=64, sketch_dim=512),
              vector=VectorIndexConfig(dim=64, capacity=capacity, block_rows=128,
                                       dtype=dtype),
              lexical=LexicalIndexConfig(postings_window=64))
    ref = RefEngine(RefConfig(batch_pad=4, approx_threshold=1, **cfg), **kw)
    port = SearchEngine(SearchEngineConfig(batch_pad=4, approx_threshold=1, **cfg),
                        **kw, device=CPU)
    for eng in (ref, port):
        eng.add_documents(docs)
    return ref, port


def _flat_docs(n=1500):
    """One short chunk per doc, no title: the identity layout."""
    return [(i, f"short doc {i} topic {'abc'[i % 3]}", "") for i in range(n)]


FLAT_QUERIES = ["topic a short", "doc topic b", "short doc 17", "topic c doc 1200"]

# Fused scores of the int8 tier. A sketch query often has a coordinate at
# exactly half its largest (q_j = q_max / 2, a 63.5 before rounding), and
# the last bit of the query's f32 norm (a sum in another order than XLA's)
# then decides whether it rounds to 63 or 64. One step moves a vector score
# by qscale * row_scale * |e8| <= q_max * e_max / 127 < 7.9e-3 for unit
# vectors; the fused score moves less.
INT8_ATOL = 1e-2


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def flat_engines(request):
    ref, port = _pair(_flat_docs(), dtype=request.param, streaming=True)
    assert port.vector_index.identity_layout
    assert port.vector_index.device_dtype == request.param
    return ref, port


@pytest.fixture
def streaming_calls(monkeypatch):
    """Counts the port's streaming vector leg, run through hybrid_query."""
    from yams_tpu_torch.search import fusion

    calls = []
    real = fusion._streaming_top_c

    def counted(*args, **kw):
        calls.append(args[1])
        return real(*args, **kw)

    monkeypatch.setattr(fusion, "_streaming_top_c", counted)
    return calls


@pytest.mark.parametrize("filters", ["none", "shared", "per_query"])
def test_streaming_tier_matches_reference(flat_engines, streaming_calls, filters):
    """A flat corpus above the (lowered) streaming threshold: the port's
    search_batch takes the streaming tier itself (its doc mask padded to
    the row count) and returns the reference's top-k."""
    ref, port = flat_engines
    atol = INT8_ATOL if port.vector_index.device_dtype == "int8" else 1e-4
    kw = {}
    if filters == "shared":
        kw["filter_doc_ids"] = set(range(0, 1500, 4))
    elif filters == "per_query":
        kw["per_query_filters"] = [set(range(0, 1500, 4)), None, {17, 18, 19}, None]
    got = port.search_batch(FLAT_QUERIES, k=5, **kw)
    assert streaming_calls == [port.vector_index.capacity]
    assert port.last_trace["scan_block_rows"] == 128
    _compare(ref.search_batch(FLAT_QUERIES, k=5, **kw), got, min_equal=1.0, atol=atol)
    if filters == "per_query":
        assert {r.doc_id for r in got[2]} <= {17, 18, 19}


def test_streaming_tier_equals_materialized_tier():
    """The same flat corpus with the streaming threshold left at its default:
    the materialized tier returns the streaming tier's results."""
    docs = _flat_docs()
    _, dense = _pair(docs)
    _, stream = _pair(docs, streaming=True)
    _compare(dense.search_batch(FLAT_QUERIES, k=5), stream.search_batch(FLAT_QUERIES, k=5),
             min_equal=1.0)


@pytest.mark.parametrize("chunk_agg", ["max", "sum", "topk_avg", "weighted_topk_avg"])
def test_int8_tier_matches_reference(chunk_agg):
    """VectorIndexConfig(dtype="int8") on a chunked corpus, every chunk
    aggregation: the reference's top-k on 95% of 20 queries, as above (a
    near-tie in the packed BM25 leg may swap two lexical ranks), scores to
    INT8_ATOL."""
    docs, queries = _corpus(120, 20, seed=3)
    ref, port = _pair(docs, dtype="int8", capacity=512, chunk_agg=chunk_agg)
    assert port.vector_index.device_dtype == "int8"
    assert port.vector_index.device_arrays()[0].dtype == torch.int8
    _compare(ref.search_batch(queries, k=10), port.search_batch(queries, k=10),
             atol=INT8_ATOL)


def test_remove_document_turns_streaming_off(streaming_calls):
    """Removing docs leaves tombstones, so the layout is no longer the
    identity and search_batch leaves the streaming tier; no removed doc is
    returned, and the results are the reference's."""
    ref, port = _pair(_flat_docs(), streaming=True)
    port.search_batch(FLAT_QUERIES[:1], k=5)
    assert len(streaming_calls) == 1
    gone = [0, 3, 6, 17, 1200, 1203]
    for eng in (ref, port):
        assert all(eng.remove_document(d) for d in gone)
        assert not eng.remove_document(10**6)
    assert not port.vector_index.identity_layout
    got = port.search_batch(FLAT_QUERIES, k=10)
    assert len(streaming_calls) == 1 and "scan_block_rows" not in port.last_trace
    assert not {r.doc_id for q in got for r in q} & set(gone)
    _compare(ref.search_batch(FLAT_QUERIES, k=10), got, min_equal=1.0)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_hotzone_and_feedback_match_reference(dtype):
    """touch_hot and record_feedback boost docs by h / (1 + h) on both
    engines; the boost vector is rebuilt only when the hot state or the
    slot layout changes, and clear_hot drops it."""
    docs, queries = _corpus(200, 10, seed=4)
    ref, port = _pair(docs, dtype=dtype, capacity=512, hotzone_weight=0.5)
    atol = INT8_ATOL if dtype == "int8" else 1e-4
    hot_docs = [docs[5][0], docs[77][0], docs[150][0]]
    for eng in (ref, port):
        eng.touch_hot(hot_docs[0], 2.0)
        eng.touch_hot(hot_docs[1])
        eng.record_feedback(hot_docs[2])
        eng.record_feedback(hot_docs[0], relevant=False)
    Nd = port.num_slots_padded
    hot = port._hot_device(Nd)
    assert np.array_equal(hot.numpy(), np.asarray(ref._hot_device(Nd)))
    assert hot[port._slot_by_doc[hot_docs[0]]] == pytest.approx(2.0 / 3.0)
    assert port._hot_device(Nd) is hot               # cached
    boosted = port.search_batch(queries, k=10)
    _compare(ref.search_batch(queries, k=10), boosted, atol=atol)
    for eng in (ref, port):
        eng.clear_hot()
    assert not port._hot_device(Nd).any()
    plain = port.search_batch(queries, k=10)
    _compare(ref.search_batch(queries, k=10), plain, atol=atol)
    assert any(a != b for a, b in zip(_ids(boosted), _ids(plain)))


@pytest.mark.parametrize("intent", ["navigational", "lookup", "conceptual", "question",
                                    "unknown"])
def test_intent_weights_match_reference(engines, intent):
    """Intent-adaptive leg weights (on by default) scale the text and vector
    weights per intent; unknown intents leave them as they are."""
    ref, docs, queries = engines
    port = SearchEngine(device=CPU)
    load_state(port, state_from_jax(ref))
    got = port.search_batch(queries[:10], intent=intent)
    assert port.last_trace["intent"] == intent
    _compare(ref.search_batch(queries[:10], intent=intent), got)


def test_search_expanded_matches_reference(engines):
    ref, docs, queries = engines
    port = SearchEngine(device=CPU)
    load_state(port, state_from_jax(ref))
    for q, exp in ((queries[0], [queries[1], "", queries[2]]), (queries[3], []),
                   (queries[4], queries[5:15])):
        want = ref.search_expanded(q, exp, k=8, intent="conceptual")
        got = port.search_expanded(q, exp, k=8, intent="conceptual")
        _compare([want], [got], min_equal=1.0)


def test_stats_match_reference(engines):
    """stats() has the reference's keys; searches count queries, documents
    count adds, and the indexes report as the reference's."""
    ref, docs, queries = engines
    port = SearchEngine(device=CPU)
    assert port.stats()["searches"] == 0 and "avg_latency_ms" not in port.stats()
    port.add_documents(docs)
    port.search_batch(queries[:5])
    port.search("thread scheduler")
    port.search_expanded(queries[0], queries[1:3])
    got, want = port.stats(), ref.stats()
    assert set(got) >= set(want) - {"avg_latency_ms"}
    assert got["searches"] == 9 and got["avg_latency_ms"] > 0
    assert got["documents"] == want["documents"] == len(docs)
    assert got["vector"] == want["vector"] and got["lexical"] == want["lexical"]
