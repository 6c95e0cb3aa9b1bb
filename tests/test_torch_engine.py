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


def _compare(ref_results, port_results, min_equal=0.95):
    same = 0
    for r, p in zip(ref_results, port_results):
        ri, pi = [x.doc_id for x in r], [x.doc_id for x in p]
        if ri == pi:
            same += 1
            np.testing.assert_allclose([x.score for x in p], [x.score for x in r],
                                       atol=1e-4, rtol=0)
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
    _, docs, queries = engines
    port = SearchEngine(SearchEngineConfig(**change), device=CPU)
    port.add_documents(docs[:20])
    with pytest.raises(NotImplementedError):
        port.search_batch(queries[:2])


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
