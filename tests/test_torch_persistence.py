"""Port parity: the indexes' files (VectorIndex and LexicalIndex save/load).

- vectors.npz / vectors.json and the pq.npz sidecar (format v3), written by
  either package and loaded by the other: equal host state, and equal
  exact and PQ searches (host and device rerank) on the dense, PQ and
  PQ4 tiers; float16 disk storage widened back on load; a stale sidecar
  removed on save.
- v1 and v2 trees migrated as the reference migrates them; a v1 tree of the
  wrong width refused as corrupt; a newer format refused as unsupported.
- lexical.pkl written by either package read by the other (plain dicts only:
  a file naming a class is refused), with the same df view.
- An engine reopened from either package's files, its slot map restored as
  the service layer restores it, searches as the engine that saved them.
- The int8 tier: the port's reload keeps int8 and equal codes when told the
  engine's dtype; the reference's reload comes back bf16 (its loader passes
  no device dtype), which this file pins.
"""

import collections
import json
import pickle

import numpy as np
import pytest
import torch

from yams_tpu.core.config import LexicalIndexConfig as RefLexicalConfig
from yams_tpu.core.errors import UnsupportedError as RefUnsupported
from yams_tpu.index.lexical_index import LexicalIndex as RefLexical
from yams_tpu.index.vector_index import VectorIndex as RefIndex
from yams_tpu.search.engine import SearchEngine as RefEngine
from yams_tpu_torch.core.config import LexicalIndexConfig
from yams_tpu_torch.core.errors import CorruptionError, UnsupportedError
from yams_tpu_torch.index.lexical_index import LexicalIndex
from yams_tpu_torch.index.vector_index import VectorIndex
from yams_tpu_torch.search.engine import SearchEngine

CPU = torch.device("cpu")
DIM = 64
PACKAGES = ("reference", "port")


def _unit(n, d=DIM, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _build(package, tier, dtype="bfloat16"):
    cls = RefIndex if package == "reference" else VectorIndex
    kw = {} if package == "reference" else {"device": CPU}
    idx = cls(dim=DIM, capacity=256, block_rows=64, device_dtype=dtype, **kw)
    vecs = _unit(700, seed=2)
    idx.add(vecs[:600], [i // 2 for i in range(600)])      # two rows a doc
    for s in (5, 77, 123):
        idx.remove_doc(s)
    idx.add(vecs[600:], list(range(1000, 1100)))           # refills freed rows
    if tier == "pq":
        idx.build_pq(m=8, ksub=32, rerank_factor=4)
    elif tier == "pq4":
        idx.build_pq(m=16, ksub=16, pack4=True, rerank_factor=4, group=8)
    return idx


def _load(package, path, **kw):
    if package == "reference":
        return RefIndex.load(path)
    return VectorIndex.load(path, device=CPU, **kw)


def _host_state(idx):
    st = {"vecs": idx._vecs[: idx._count], "valid": idx._valid[: idx._count],
          "slots": idx._slots[: idx._count], "count": idx._count,
          "free": sorted(idx._free), "rows_by_slot": idx._rows_by_slot,
          "dim": idx.dim, "block_rows": idx.block_rows, "space_id": idx.space_id,
          "capacity": idx.capacity, "has_pq": idx.has_pq}
    if idx.has_pq:
        cb = idx._pq_codebook
        cent = cb.centroids
        st.update(codes=idx._pq_codes,
                  centroids=cent.numpy() if isinstance(cent, torch.Tensor) else np.asarray(cent),
                  pq=(cb.m, cb.ksub, cb.dsub, idx._pq_packed4, idx._pq_rerank_factor,
                      idx._pq_built_rows, idx._pq_group))
    return st


def _assert_state_equal(a, b):
    sa, sb = _host_state(a), _host_state(b)
    assert sa.keys() == sb.keys()
    for key in sa:
        if isinstance(sa[key], np.ndarray):
            assert np.array_equal(sa[key], sb[key]), key
        else:
            assert sa[key] == sb[key], key


def _searches(idx, q):
    out = [idx.search(q, k=7)]
    if idx.has_pq:
        out += [idx.search_pq(q, k=5, rerank="host"), idx.search_pq(q, k=5, rerank="device")]
    return [(np.asarray(v), np.asarray(r)) for v, r in out]


@pytest.mark.parametrize("tier", ["dense", "pq", "pq4"])
@pytest.mark.parametrize("writer", PACKAGES)
def test_vector_files_round_trip(tmp_path, writer, tier):
    """Either package's files load in both; every load holds the writer's
    state and searches alike."""
    src = _build(writer, tier)
    src.save(tmp_path)
    assert (tmp_path / "pq.npz").exists() == (tier != "dense")
    meta = json.loads((tmp_path / "vectors.json").read_text())
    assert meta["format_version"] == 3 and meta["has_pq"] == (tier != "dense")
    ref, port = _load("reference", tmp_path), _load("port", tmp_path)
    _assert_state_equal(port, ref)
    if writer == "port":
        assert np.array_equal(port._vecs[:port._count], src._vecs[:src._count])
    q = _unit(9, seed=5)
    for (pv, pr), (rv, rr) in zip(_searches(port, q), _searches(ref, q), strict=True):
        assert np.array_equal(pr, rr)
        np.testing.assert_allclose(pv, rv, atol=1e-6, rtol=0)
    if tier != "dense":
        assert isinstance(port._pq_codebook.centroids, torch.Tensor)


@pytest.mark.parametrize("writer", PACKAGES)
def test_float16_disk_and_stale_sidecar(tmp_path, writer):
    """float16 on disk widens back to float32 on load; saving an index
    without PQ over a tree that had a sidecar removes it."""
    _build(writer, "pq4").save(tmp_path)
    plain = _build(writer, "dense")
    plain.save(tmp_path, disk_dtype="float16")
    assert not (tmp_path / "pq.npz").exists()
    with np.load(tmp_path / "vectors.npz") as raw:
        assert raw["vecs"].dtype == np.float16
    ref, port = _load("reference", tmp_path), _load("port", tmp_path)
    assert port._vecs.dtype == np.float32 and not port.has_pq
    _assert_state_equal(port, ref)
    want = plain._vecs[:plain._count].astype(np.float16).astype(np.float32)
    assert np.array_equal(port._vecs[:port._count], want)


def _old_tree(path, version, dim=DIM):
    vecs = _unit(50, d=dim, seed=9)
    np.savez_compressed(path / "vectors.npz",
                        vecs=vecs.astype(np.float16 if version == 2 else np.float32),
                        valid=np.ones(50, np.float32), slots=np.arange(50, dtype=np.int32))
    meta = {"dim": DIM, "count": 50, "space_id": "s", "block_rows": 64}
    if version == 2:
        meta.update(format_version=2, disk_dtype="float16")
    (path / "vectors.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("version", [1, 2])
def test_old_formats_migrate(tmp_path, version):
    _old_tree(tmp_path, version)
    ref, port = _load("reference", tmp_path), _load("port", tmp_path)
    _assert_state_equal(port, ref)
    assert not port.has_pq and port.active_rows == 50
    q = _unit(3, seed=1)
    assert np.array_equal(port.search(q, k=4)[1], np.asarray(ref.search(q, k=4)[1]))


def test_v1_tree_of_the_wrong_width_is_corrupt(tmp_path):
    _old_tree(tmp_path, 1, dim=DIM + 1)
    with pytest.raises(CorruptionError):
        _load("port", tmp_path)


def test_newer_format_refused(tmp_path):
    _build("port", "dense").save(tmp_path)
    meta = json.loads((tmp_path / "vectors.json").read_text())
    meta["format_version"] = 4
    (tmp_path / "vectors.json").write_text(json.dumps(meta))
    with pytest.raises(UnsupportedError, match="v4"):
        _load("port", tmp_path)
    with pytest.raises(RefUnsupported):
        _load("reference", tmp_path)


def test_int8_kept_by_the_port_reload(tmp_path):
    """The port's reload keeps the engine's int8 tier (equal codes and
    scales); the reference's loader passes no device dtype, so its reload
    of the same files comes back bf16 (a reference fault, pinned here)."""
    src = _build("port", "dense", dtype="int8")
    src.save(tmp_path)
    port = _load("port", tmp_path, device_dtype="int8")
    assert port.device_dtype == "int8"
    want, got = src.device_arrays(), port.device_arrays()
    n = src._count
    for a, b in zip(want, got):
        assert np.array_equal(a[:n].numpy(), b[:n].numpy())
    assert got[0].dtype == torch.int8
    q = _unit(4, seed=6)
    assert np.array_equal(port.search(q, k=5)[1], src.search(q, k=5)[1])
    ref = _load("reference", tmp_path)
    assert ref.device_dtype == "bfloat16"
    assert _load("port", tmp_path).device_dtype == "bfloat16"


# -- the lexical index ---------------------------------------------------------------
DOCS = [(0, "thread scheduler preempts threads", "sched"),
        (3, "chunk hashing and content dedup", "cas"),
        (4, "the scheduler runs run_queue per-cpu", ""),
        (9, "snapshot of the chunk store", "snap")]


@pytest.mark.parametrize("writer", PACKAGES)
def test_lexical_files_round_trip(tmp_path, writer):
    lexes = {"reference": RefLexical(RefLexicalConfig()), "port": LexicalIndex()}
    for slot, text, title in DOCS:
        for lex in lexes.values():
            lex.add_document(slot, text, title)
    lexes[writer].remove_document(4)
    lexes[writer].save(tmp_path)
    ref = RefLexical.load(tmp_path, RefLexicalConfig())
    port = LexicalIndex.load(tmp_path, LexicalIndexConfig())
    for a in (ref, port):
        assert a._vocab == lexes[writer]._vocab and a._docs == lexes[writer]._docs
        assert a._doc_len == lexes[writer]._doc_len
    assert port._postings == ref._postings and port._stem_index == ref._stem_index
    assert port.stats() == ref.stats()
    assert json.loads((tmp_path / "lexical.json").read_text()) == ref.stats()
    for term in ("scheduler", "chunk", "run_queue", "missing"):
        assert port.df_view().get(term, -1) == ref.df_view().get(term, -1)
    for q in ("scheduler threads", "chunk dedup snapshot"):
        assert [list(x) for x in port.query_term_ids(q)] == \
            [list(x) for x in ref.query_term_ids(q)]
    arrs_p, arrs_r = port.build_arrays(16), ref.build_arrays(16)
    for key in ("postings_doc", "postings_impact", "term_offsets", "term_lengths"):
        assert np.array_equal(np.asarray(arrs_p[key]), np.asarray(arrs_r[key])), key


def test_lexical_load_refuses_classes(tmp_path):
    with open(tmp_path / "lexical.pkl", "wb") as f:
        pickle.dump({"vocab": collections.Counter(), "docs": {}, "doc_len": {},
                     "num_slots": 0}, f)
    with pytest.raises(pickle.UnpicklingError, match="Counter"):
        LexicalIndex.load(tmp_path)


# -- an engine reopened ---------------------------------------------------------------
def _restore_slot_map(engine, pairs):
    """The service layer's slot-map restore: (slot, doc_id) pairs, gaps -1."""
    engine._doc_by_slot, engine._slot_by_doc = [], {}
    for slot, doc_id in sorted(pairs):
        while len(engine._doc_by_slot) < slot:
            engine._doc_by_slot.append(-1)
        engine._doc_by_slot.append(doc_id)
        engine._slot_by_doc[doc_id] = slot


@pytest.mark.parametrize("writer", PACKAGES)
def test_engine_reopens_saved_indexes(tmp_path, writer):
    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(200)] + ["scheduler", "chunk", "raft"]
    docs = [(500 + i, " ".join(words[z % len(words)] for z in rng.zipf(1.3, 20)) + ".",
             f"t{i}") for i in range(120)]
    queries = [" ".join(words[z % len(words)] for z in rng.zipf(1.3, 3)) for _ in range(12)]
    # the CSR lexical leg: the packed leg's BM25 sums drift a few ulps from
    # the reference's, and a near-tie reordered moves the RRF term by ~4e-3
    lex = LexicalIndexConfig(packed_max_entries=0)
    src = (RefEngine(lexical=RefLexicalConfig(packed_max_entries=0)) if writer == "reference"
           else SearchEngine(lexical=lex, device=CPU))
    src.add_documents(docs)
    src.remove_document(507)
    want = src.search_batch(queries)
    src.vector_index.save(tmp_path)
    src.lexical_index.save(tmp_path)
    pairs = [(s, d) for d, s in src._slot_by_doc.items()]
    port = SearchEngine(lexical=lex, device=CPU)
    port.vector_index = VectorIndex.load(tmp_path, device=CPU)
    port.lexical_index = LexicalIndex.load(tmp_path, lex)
    _restore_slot_map(port, pairs)
    got = port.search_batch(queries)
    for r, p in zip(want, got, strict=True):
        assert [x.doc_id for x in p] == [x.doc_id for x in r]
        np.testing.assert_allclose([x.score for x in p], [x.score for x in r],
                                   atol=1e-4, rtol=0)
    assert all(x.doc_id != 507 for res in got for x in res)
