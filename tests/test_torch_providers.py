"""The port's embedding providers and their registry (yams_tpu_torch/embed/
provider.py) against the reference's, and the model surface of AppContext,
the CLI and the daemon on the CPU.

- `list_providers` and `create_provider` name the same providers; each
  built provider has the reference's name, dim and space id, apart from
  `neural` without weights (the port's seeded space, `neural-torch/...`);
  `register_provider` adds a factory and an unknown name raises ValueError.
- `MockProvider` encodes bit for bit as the reference's; every provider's
  `query_device_inputs` gives its host vectors and a bf16 identity on its
  device.
- AppContext with `embedding.provider` mock, hf and neural adds a seeded
  tree and searches; mock answers the reference's AppContext's hits
  (scores within 1e-6: the same vectors), hf the same top hits with scores
  within 2e-3 (bf16 compute in both packages: the encoders' outputs differ
  by ~1e-4), and each registers its provider's space.
- `yams model list` prints the reference CLI's models for the same tree
  and provider; with a daemon on the data dir it reads the table without
  opening a second AppContext.
"""

import json

import numpy as np
import pytest
import torch

from chip_smoke import ThreadDaemon, results_agree
from test_torch_cli import port, ref, run
from test_torch_services import make_tree, port_config_for, ref_config_for
from yams_tpu.cli.main import main as ref_main
from yams_tpu.embed import provider as ref_provider
from yams_tpu.services.app import AppContext as RefApp
from yams_tpu_torch.cli.main import main as port_main
from yams_tpu_torch.embed import provider as port_provider
from yams_tpu_torch.services.app import AppContext

CPU = torch.device("cpu")
KWARGS = {"simeon": {}, "mock": {"dim": 48}, "hf": {},
          "neural": {"dim": 96, "max_len": 64}}


def test_registry_matches_reference():
    # the reference's registry is global: its own tests may have added to it
    assert port_provider.list_providers() == ["hf", "mock", "neural", "simeon"]
    assert set(port_provider.list_providers()) <= set(ref_provider.list_providers())
    with pytest.raises(ValueError, match="unknown embedding provider: 'nope'"):
        port_provider.create_provider("nope", device="cpu")

    class Custom(port_provider.MockProvider):
        name = "custom"

    port_provider.register_provider("custom", Custom)
    try:
        assert port_provider.create_provider("custom", device="cpu").name == "custom"
    finally:
        port_provider._REGISTRY.pop("custom")


@pytest.mark.parametrize("name", sorted(KWARGS))
def test_providers_match_reference(name):
    p = port_provider.create_provider(name, device="cpu", **KWARGS[name])
    r = ref_provider.create_provider(name, **KWARGS[name])
    assert (p.name, p.dim) == (r.name, r.dim)
    if name == "neural":
        assert p.space_id == r.space_id.replace("neural/", "neural-torch/", 1)
    else:
        assert p.space_id == r.space_id
    texts = ["raft consensus snapshot", "merkle tree diff detects renames", ""]
    vecs, proj = p.query_device_inputs(texts)
    assert vecs.shape == (3, p.dim) and vecs.dtype == np.float32
    assert proj.dtype == torch.bfloat16 and proj.device == CPU
    assert torch.equal(proj, torch.eye(p.dim, dtype=torch.bfloat16))
    if name == "mock":
        np.testing.assert_array_equal(p.encode(texts), r.encode(texts))


def _app_pair(tmp_path, provider, tree):
    pc, rc = port_config_for(tmp_path / "port"), ref_config_for(tmp_path / "ref")
    for cfg in (pc, rc):
        cfg.embedding.provider = provider
    papp, rapp = AppContext(pc, device="cpu"), RefApp(rc)
    for app in (papp, rapp):
        app.indexing.add_directory(tree)
    return papp, rapp


QUERIES = ["raft consensus", "scheduler thread", "chunk hashing dedup", "memory routing"]


@pytest.mark.parametrize("provider,atol", [("mock", 1e-6), ("hf", 2e-3)])
def test_app_context_serves_the_provider(tmp_path, provider, atol):
    tree = make_tree(tmp_path / "tree", n_notes=24)
    papp, rapp = _app_pair(tmp_path, provider, tree)
    try:
        pe, re_ = papp.search_engine, rapp.search_engine
        assert pe.provider.name == provider and pe.provider.device == CPU
        assert pe.provider.space_id == re_.provider.space_id
        assert papp.metadata.latest_vector_model() == rapp.metadata.latest_vector_model()
        got = pe.search_batch(QUERIES, k=5)
        want = re_.search_batch(QUERIES, k=5)
        if provider == "mock":
            results_agree("mock app", got, want, atol=atol)
        else:
            for g, w in zip(got, want):
                assert g[0].doc_id == w[0].doc_id
                assert abs(g[0].score - w[0].score) <= atol
    finally:
        papp.close()
        rapp.close()


def test_app_context_with_the_neural_provider(tmp_path):
    cfg = port_config_for(tmp_path / "d")
    cfg.embedding.provider = "neural"
    app = AppContext(cfg, device="cpu")
    try:
        app.documents.add_bytes(b"raft consensus elects a leader", "raft.txt")
        app.documents.add_bytes(b"chunk hashing and dedup", "cas.txt")
        assert app.search.search("raft leader").hits[0].path == "/raft.txt"
        _, dim, space = app.metadata.latest_vector_model()
        assert (dim, space) == (384, "neural-torch/d384/L6/seed0/v1")
    finally:
        app.close()


@pytest.mark.parametrize("provider", ["simeon", "hf"])
def test_model_list_matches_reference(tmp_path, capsys, monkeypatch, provider):
    monkeypatch.setenv("YAMS_TPU_EMBEDDING_PROVIDER", provider)
    tree = make_tree(tmp_path / "tree", n_notes=6)
    out = {}
    for label, main, argv in (("port", port_main, port), ("ref", ref_main, ref)):
        rc, _, _ = run(main, capsys, *argv(tmp_path / label, "add", str(tree)))
        assert rc == 0
        rc, text, _ = run(main, capsys, "--json", *argv(tmp_path / label, "model", "list"))
        assert rc == 0
        out[label] = json.loads(text)
    assert out["port"] == out["ref"] and len(out["port"]) == 1
    assert out["port"][0]["model_id"] == ("fixed_hash_384" if provider == "simeon" else "hf")


def test_model_list_beside_a_daemon_reads_the_table(tmp_path, capsys, monkeypatch):
    import shutil
    import tempfile
    from pathlib import Path

    import yams_tpu_torch.services.app as app_module

    sock = Path(tempfile.mkdtemp(prefix="ym"))
    cfg = port_config_for(tmp_path / "data")
    cfg.daemon.socket_path = str(sock / "d.sock")
    d = ThreadDaemon(cfg, CPU, timeout=120)
    try:
        status = d.client.call("model_status")

        def refuse(*a, **kw):
            raise AssertionError("model list opened an AppContext beside the daemon")

        monkeypatch.setattr(app_module, "AppContext", refuse)
        monkeypatch.setenv("YAMS_TPU_SOCKET", cfg.daemon.socket_path)
        rc, text, _ = run(port_main, capsys, "--storage", str(tmp_path / "data"),
                          "--device", "cpu", "--json", "model", "list")
        assert rc == 0
        rows = json.loads(text)
        assert [(r["dim"], r["space_id"]) for r in rows] == \
            [(status["default"]["dim"], status["default"]["space_id"])]
    finally:
        d.stop()
        shutil.rmtree(sock, ignore_errors=True)
