"""Sharded serving through the port's engine and AppContext, on the CPU.

The reference's five tests of tests/test_sharded_engine.py rerun on the
port's `AppContext(device="cpu")` with `parallel.mesh.visible_devices`
patched to eight CPU devices (the reference's conftest forces eight virtual
CPU devices), so "auto" and "on" arm a mesh of eight CPU shards. As there,
the sharded answers are held to the same app unarmed at the reference's
engine gate (the same hit names, scores within 2e-2). The same documents
also go through the reference's sharded AppContext (JAX, eight virtual
devices): on the CSR lexical leg the port's sharded hits have the
reference's names with scores within 1e-4 (the vector scores are f32 sums
of bf16 products in another order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yams_tpu.core import config as ref_config
from yams_tpu.search.config import SearchEngineConfig as RefSearchConfig
from yams_tpu.services.app import AppContext as RefApp
from yams_tpu_torch.core import config as port_config
from yams_tpu_torch.parallel import mesh as port_mesh
from yams_tpu_torch.search.config import SearchEngineConfig
from yams_tpu_torch.services import app as port_app_module
from yams_tpu_torch.services.app import AppContext

CPU = torch.device("cpu")

DOCS = [
    ("kernel.md", "the kernel scheduler preempts threads with priority "
                  "queues and interrupt masking on every core"),
    ("pasta.md", "boil pasta add tomato basil and olive oil with fresh "
                 "ground pepper and a pinch of salt"),
    ("grad.md", "gradients update network weights during training with "
                "momentum and learning rate decay"),
    ("locks.md", "mutex locks protect shared kernel state from concurrent "
                 "writer threads"),
    ("salad.md", "fresh tomato basil salad with olive oil dressing and "
                 "toasted pine nuts"),
    ("sched.md", "the scheduler balances runnable threads across cores "
                 "respecting cgroup weight"),
]
QUERIES = ["kernel thread locks", "tomato basil olive", "gradient training",
           "scheduler core balance"]


def small_config(cfg_module, search_cls, data_dir, csr: bool = False):
    """tests/test_services.py's small_config; `csr` takes the CSR lexical leg."""
    cfg = cfg_module.Config(data_dir=data_dir)
    cfg.chunking = cfg_module.ChunkingConfig(min_size=1024, avg_size=4096, max_size=16384)
    cfg.embedding = cfg_module.EmbeddingConfig(dim=64, sketch_dim=512)
    cfg.vector = cfg_module.VectorIndexConfig(dim=64, capacity=256, block_rows=128)
    cfg.lexical = cfg_module.LexicalIndexConfig(
        postings_window=64, **({"packed_max_entries": 0} if csr else {}))
    cfg.search = search_cls()
    return cfg


@pytest.fixture()
def eight_devices(monkeypatch):
    """Eight CPU devices stand in for eight cards."""
    eight = lambda device: [CPU] * 8  # noqa: E731
    monkeypatch.setattr(port_mesh, "visible_devices", eight)
    monkeypatch.setattr(port_app_module, "visible_devices", eight)


def _build(tmp_path, monkeypatch, mode, csr=False):
    monkeypatch.setenv("YAMS_VECTOR_SHARDED", mode)
    app = AppContext(small_config(port_config, SearchEngineConfig,
                                  tmp_path / f"data-{mode}", csr), device="cpu")
    for name, text in DOCS:
        app.documents.add_bytes(text.encode(), name)
    return app


def _hits(app):
    return [[(h.name, h.score) for h in app.search.search(q, limit=4, with_snippets=False).hits]
            for q in QUERIES]


def _same_hits(got, want, atol):
    for q, a, b in zip(QUERIES, got, want):
        assert [h[0] for h in a] == [h[0] for h in b], q
        np.testing.assert_allclose([h[1] for h in a], [h[1] for h in b], atol=atol,
                                   rtol=0, err_msg=q)


class TestEngineShardedServing:
    def test_appcontext_arms_mesh_and_serves_with_parity(
            self, tmp_path, monkeypatch, eight_devices):
        sh = _build(tmp_path, monkeypatch, "auto")
        try:
            assert sh.search_engine._shard_mesh is not None and sh.sharded
            sh_out = _hits(sh)
            # the batch ran sharded (the trace names the route)
            assert sh.search_engine.last_trace.get("sharded_devices") == 8
            snap = sh.stats.snapshot(detailed=True)
            assert snap["sharded"] is True and snap["mesh"]["shape"] == {"d": 8}
        finally:
            sh.close()
        sd = _build(tmp_path, monkeypatch, "off")
        try:
            assert sd.search_engine._shard_mesh is None and not sd.sharded
            sd_out = _hits(sd)
            assert "sharded_devices" not in sd.search_engine.last_trace
        finally:
            sd.close()
        _same_hits(sh_out, sd_out, atol=2e-2)

    def test_filtered_search_parity_sharded(self, tmp_path, monkeypatch, eight_devices):
        """Per-query doc masks (the daemon's filtered batch) ride the sharded
        program as dedup'd uint8 rows and mask_idx."""
        sh = _build(tmp_path, monkeypatch, "auto")
        try:
            resp = sh.search.search("tomato basil", limit=5, path_glob="*salad*",
                                    with_snippets=False)
            assert [h.name for h in resp.hits] == ["salad.md"]
            assert sh.search_engine.last_trace.get("sharded_devices") == 8
            out = sh.search.search_many_requests([
                {"query": "tomato basil", "path_glob": "*salad*"},
                {"query": "tomato basil"},
                {"query": "kernel thread locks", "path_glob": "*locks*"},
            ])
            assert [h.name for h in out[0].hits] == ["salad.md"]
            assert len(out[1].hits) >= 2
            assert [h.name for h in out[2].hits] == ["locks.md"]
            assert sh.search_engine.last_trace.get("sharded_devices") == 8
        finally:
            sh.close()

    def test_mutations_reshard_on_next_search(self, tmp_path, monkeypatch, eight_devices):
        """Ingest after arming: the sharded view re-places on mutation_gen,
        new docs are searchable and deleted ones fall out."""
        sh = _build(tmp_path, monkeypatch, "auto")
        try:
            vi = sh.search_engine.vector_index
            gen0, up0 = vi.mutation_gen, vi.upload_bytes_total
            sh.search.search("kernel", limit=1, with_snippets=False)
            placed = vi.upload_bytes_total - up0
            assert placed > 0
            sh.documents.add_bytes(b"zanzibar spice markets sell cardamom and cloves",
                                   "spice.md")
            assert vi.mutation_gen > gen0
            resp = sh.search.search("zanzibar cardamom cloves", limit=3,
                                    with_snippets=False)
            assert resp.hits and resp.hits[0].name == "spice.md"
            assert sh.search_engine.last_trace.get("sharded_devices") == 8
            sh.documents.delete("spice.md")
            resp = sh.search.search("zanzibar cardamom cloves", limit=3,
                                    with_snippets=False)
            assert all(h.name != "spice.md" for h in resp.hits)
        finally:
            sh.close()

    def test_pq_tier_falls_back_single_device(self, tmp_path, monkeypatch, eight_devices):
        sh = _build(tmp_path, monkeypatch, "auto")
        try:
            eng = sh.search_engine
            assert eng._sharded_eligible(use_pq=False)
            assert not eng._sharded_eligible(use_pq=True)
            monkeypatch.setattr(eng.config, "chunk_agg", "sum")
            assert not eng._sharded_eligible(use_pq=False)
            sh.search.search("kernel thread", limit=3, with_snippets=False)
            assert "sharded_devices" not in eng.last_trace
        finally:
            sh.close()

    def test_sharded_on_requires_mesh(self, tmp_path, monkeypatch, eight_devices):
        app = _build(tmp_path, monkeypatch, "on")
        try:
            assert app.search_engine._shard_mesh is not None
        finally:
            app.close()


def test_on_with_one_device_raises(tmp_path, monkeypatch):
    """The CPU is one device: "on" raises the reference's error, "auto"
    serves on it."""
    monkeypatch.setenv("YAMS_VECTOR_SHARDED", "on")
    cfg = small_config(port_config, SearchEngineConfig, tmp_path / "d")
    with pytest.raises(RuntimeError, match="only one device is visible"):
        AppContext(cfg, device="cpu")
    monkeypatch.setenv("YAMS_VECTOR_SHARDED", "auto")
    app = AppContext(cfg, device="cpu")
    try:
        assert not app.sharded and not app.search_engine.enable_sharding()
    finally:
        app.close()


def test_matches_reference_sharded_app(tmp_path, monkeypatch, eight_devices):
    """Both packages' sharded AppContexts over the same documents, on the
    CSR lexical leg: the same hit names, scores within 1e-4."""
    import jax

    from yams_tpu.parallel import sharded_hybrid as ref_sharded

    assert jax.device_count() == 8
    # jitted: called eagerly, the reference's shard_map dispatches op by op
    # (~13 s a search on the virtual mesh); the engine imports it at call time
    monkeypatch.setattr(ref_sharded, "sharded_hybrid_query", jax.jit(
        ref_sharded.sharded_hybrid_query, static_argnums=(0,), static_argnames=(
            "k", "rrf_cand", "window", "num_slots", "int8_corpus", "axis",
            "packed_lexical", "bm25_prefilter")))
    monkeypatch.setenv("YAMS_VECTOR_SHARDED", "auto")
    ref = RefApp(small_config(ref_config, RefSearchConfig, tmp_path / "ref", csr=True))
    try:
        for name, text in DOCS:
            ref.documents.add_bytes(text.encode(), name)
        want = _hits(ref)
        assert ref.search_engine.last_trace.get("sharded_devices") == 8
    finally:
        ref.close()
    port = _build(tmp_path, monkeypatch, "auto", csr=True)
    try:
        got = _hits(port)
        assert port.search_engine.last_trace.get("sharded_devices") == 8
    finally:
        port.close()
    _same_hits(got, want, atol=1e-4)
