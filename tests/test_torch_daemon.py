"""The port's daemon on the CPU, on a background thread with a real AF_UNIX
socket (as tests/test_interfaces.py runs the reference's):

- ping and status name the backend ("torch") and the device;
- add_path of a seeded tree and searches through the socket, one at a time
  and from 8 client threads through the SearchBatcher, equal to an
  in-process AppContext over the same tree;
- checkpoint, shutdown and a restart on the same dir: the same documents
  and the same answers;
- `queue wait_idle` returns as soon as the post-ingest worker drains, while
  that worker needs the state lock (the reference holds the lock across the
  wait), and a batch envelope refuses it;
- `feedback` with no id answers InvalidArgument; the grep, session,
  download-job and plugin handlers (UNSUPPORTED until their services were
  ported) answer what their services answer in-process; `model_load`,
  `model_status` and `embed_batch` with a loaded model answer as the
  reference's providers; `repair`
  (with and without dry_run) and `doctor` answer as the reference's
  RepairService on the same tree; trusted plugins (the bundled NER plugin)
  autoload, and one that fails to load starts the daemon DEGRADED;
- `spawn_daemon` and `python -m yams_tpu_torch.daemon` run the port's
  daemon on the device they are given.

Every join and wait has its own timeout.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import pytest
import torch

from chip_smoke import ThreadDaemon, hits_of
from test_torch_services import (SEARCHES, TAGGED, make_tree, populate, port_config_for,
                                 reference_native, reference_native_build)  # noqa: F401
from yams_tpu_torch.core.config import load_config
from yams_tpu_torch.core.errors import ErrorCode, YamsError
from yams_tpu_torch.daemon.client import DaemonClient
from yams_tpu_torch.daemon.server import spawn_daemon
from yams_tpu_torch.services.app import AppContext

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture()
def short_dir():
    """A short directory for sockets (AF_UNIX paths are limited to ~107 bytes)."""
    d = pathlib.Path(tempfile.mkdtemp(prefix="yd"))
    yield d
    shutil.rmtree(d, ignore_errors=True)


def daemon_config(data_dir, sock_dir):
    cfg = port_config_for(data_dir)
    cfg.daemon.socket_path = str(sock_dir / "d.sock")
    return cfg


@pytest.fixture()
def daemon(tmp_path, short_dir):
    d = ThreadDaemon(daemon_config(tmp_path / "data", short_dir), CPU, timeout=120)
    yield d
    if d.thread.is_alive():
        d.stop()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"), n_notes=120)


def _fields(kw):
    return {"limit": 10, "search_type": "hybrid", **kw}


def _same(a, b, atol=1e-6):
    assert [r.doc_id for r in a] == [r.doc_id for r in b] and a
    assert max(abs(x.score - y.score) for x, y in zip(a, b)) <= atol


def _add_tagged(client):
    for name, text, tags, coll in TAGGED:
        client.add_bytes(text.encode(), name, tags=tags, collection=coll)


def test_ping_and_status_name_the_backend(daemon):
    pong = daemon.client.call("ping")
    assert pong["pong"] and pong["backend"] == "torch" and pong["device"] == "cpu"
    st = daemon.client.status(detailed=True)
    assert st["backend"] == "torch" and st["device"] == "cpu" and st["devices"] == ["cpu"]
    assert st["sharded"] is False and "plugins" not in st["degraded"]
    assert daemon.app.search_engine.device == CPU and daemon.app.content_store.device == CPU


def test_add_search_checkpoint_restart(tree, tmp_path, short_dir):
    """The daemon's adds and searches against an in-process app over the same
    tree; then a checkpoint, a shutdown and a restart answer the same."""
    app = AppContext(port_config_for(tmp_path / "inproc"), device="cpu")
    want_rep = populate(app, tree)
    cfg = daemon_config(tmp_path / "data", short_dir)
    d = ThreadDaemon(cfg, CPU, timeout=120)
    try:
        rep = d.client.add_path(str(tree))
        _add_tagged(d.client)
        assert {k: v for k, v in rep.items() if k != "errors"} == \
            {k: getattr(want_rep, k) for k in rep if k != "errors"}
        fields = [_fields(kw) for _, kw in SEARCHES]
        want = [hits_of(app.search.search_many_requests([f])[0]) for f in fields]
        got = [hits_of(d.client.call("search", **f)) for f in fields]
        for g, w in zip(got, want):
            _same(g, w)
        # 8 client threads at once: the SearchBatcher fuses them
        out, errors = [None] * 32, []

        def worker(i):
            c = DaemonClient(cfg.socket_path)
            try:
                for j in range(i, 32, 8):
                    out[j] = hits_of(c.call("search", **fields[j % len(fields)]))
            except Exception as e:       # noqa: BLE001  (asserted below)
                errors.append(e)
            finally:
                c.close()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads) and not errors
        for j, g in enumerate(out):
            _same(g, want[j % len(fields)], atol=1e-5)
        assert d.client.status()["search_batching"]["batches"] >= 1
        d.client.call("checkpoint")
        docs = d.client.status()["documents"]
        d.stop()
        d = ThreadDaemon(cfg, CPU, timeout=120)
        assert d.client.status()["documents"] == docs
        for f, w in zip(fields, got):
            _same(hits_of(d.client.call("search", **f)), w, atol=0)
    finally:
        app.close()
        if d.thread.is_alive():
            d.stop()


def test_wait_idle_returns_while_the_worker_needs_the_lock(daemon):
    """The post-ingest worker takes the write side of the state lock for each
    stage; wait_idle, waiting for it, must not hold that lock. The queue is
    paused, 16 async adds are queued, a client waits (60 s timeout) and the
    queue is resumed from another client: the wait ends as the queue drains."""
    c = daemon.client
    c.call("queue", op="pause")
    for i in range(16):
        c.add_bytes(f"async note {i} raft consensus w{i}".encode(), f"async/{i}.txt",
                    async_ingest=True)
    result, waiter = {}, DaemonClient(daemon.daemon.config.socket_path)

    def wait():
        t = time.perf_counter()
        result["resp"] = waiter.call("queue", op="wait_idle", timeout=60.0)
        result["s"] = time.perf_counter() - t

    th = threading.Thread(target=wait)
    th.start()
    time.sleep(0.5)
    assert th.is_alive()                   # still waiting: the queue is paused
    c.call("queue", op="resume")
    th.join(timeout=30)
    waiter.close()
    assert not th.is_alive() and result["s"] < 30
    resp = result["resp"]
    assert resp["idle"] and resp["stages"]["embedding"]["processed"] == 16
    assert all(st["failed"] == 0 for st in resp["stages"].values())
    assert c.search("raft consensus async", limit=3)["hits"]
    batch = c.call("batch", requests=[{"type": "queue", "op": "wait_idle"},
                                      {"type": "queue", "op": "status"}])
    assert not batch["responses"][0]["ok"] and batch["responses"][1]["ok"]


def test_feedback_needs_an_id(daemon):
    c = daemon.client
    with pytest.raises(YamsError, match="doc_id or a hash") as e:
        c.call("feedback")
    assert e.value.code == ErrorCode.INVALID_ARGUMENT
    res = c.add_bytes(b"raft consensus feedback note", "fb.txt")
    assert c.call("feedback", doc_id=res["document_id"])["doc_id"] == res["document_id"]
    assert c.call("feedback", hash=res["content_hash"])["doc_id"] == res["document_id"]


def _blob_url(tmp_path):
    src = tmp_path / "dl.txt"
    src.write_text("downloaded raft consensus payload body")
    return src.as_uri()


@pytest.mark.parametrize("rtype,fields,item", [
    ("grep", {"pattern": "raft"}, 3), ("session", {"op": "list"}, 3),
    ("download", {"url": None}, 3),
    ("download_start", {"url": None}, 3), ("download_list", {}, 3),
    ("cancel", {"job_id": None}, 3), ("plugins", {}, 3), ("plugin_scan", {}, 3),
    ("plugin_trust_list", {}, 3)])
def test_unported_handlers_answer_unsupported(daemon, tmp_path, rtype, fields, item):
    """The handlers that answered UNSUPPORTED (ROADMAP queue 1 item 3) until
    their services were ported answer what the services answer in-process:
    the daemon's own app (grep, session, the download jobs) or a
    PluginManager on the same trust file."""
    from yams_tpu_torch.plugins.manager import PluginManager

    c, app = daemon.client, daemon.app
    _add_tagged(c)
    url = _blob_url(tmp_path)
    fields = {k: (url if k == "url" else v) for k, v in fields.items()}
    if rtype == "cancel":
        fields["job_id"] = c.call("download_start", url=url)["job_id"]
    got = c.call(rtype, **fields)
    if rtype == "grep":
        want = app.grep.grep("raft")
        assert [(m["document_id"], m["line"]) for m in got["matches"]] == \
            [(m.document_id, m.line) for m in want.matches] and want.matches
    elif rtype == "session":
        app.sessions.create("s1")
        assert got == {"sessions": []} and c.call(rtype, **fields) == {"sessions": ["s1"]}
    elif rtype == "download":
        assert got["sha256"] == app.content_store.store_bytes(
            b"downloaded raft consensus payload body").content_hash
        assert got["document_id"] > 0 and got["url"] == url
        hits = c.search("downloaded payload", search_type="keyword")["hits"]
        assert hits and hits[0]["document_id"] == got["document_id"]
    elif rtype in ("download_start", "cancel"):
        job = got["job_id"]
        deadline = time.monotonic() + 60
        while (st := c.call("download_status", job_id=job))["state"] in ("queued", "running"):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert st == app.downloads.job_status(job)
        assert st["state"] in (("completed",) if rtype == "download_start"
                               else ("completed", "cancelled"))
    elif rtype == "download_list":
        assert got == {"jobs": []}
        job = c.call("download_start", url=url)["job_id"]
        assert [j["job_id"] for j in c.call(rtype)["jobs"]] == [job]
    else:
        pm = PluginManager(app, trust_file=app.config.data_dir / "plugins_trust.txt")
        want = {"plugins": {"plugins": pm.list(), "health": pm.health()},
                "plugin_scan": {"found": pm.scan(), "plugins": pm.list()},
                "plugin_trust_list": {"trusted": []}}[rtype]
        assert got == want


@pytest.mark.parametrize("model,options", [("mock", {"dim": 32}),
                                           ("hf", {"compute_dtype": "float32"})])
def test_model_load_status_and_embed_batch(daemon, model, options):
    """`model_load` builds the provider on the daemon's device, `model_status`
    lists it beside the default, and `embed_batch` with that model answers
    the reference provider's vectors (mock: bit for bit; hf at f32: 1e-5)."""
    import numpy as np

    from yams_tpu.embed.provider import create_provider as ref_create
    from yams_tpu_torch.embed.provider import list_providers

    c = daemon.client
    want = ref_create(model, **options)
    loaded = c.call("model_load", model=model, options=options)
    assert loaded == {"model": model, "dim": want.dim, "space_id": want.space_id}
    assert daemon.daemon._models[model].device == CPU
    st = c.call("model_status")
    assert st["loaded"] == [{"name": model, "dim": want.dim, "space_id": want.space_id}]
    assert st["registry"] == list_providers() == ["hf", "mock", "neural", "simeon"]
    assert st["default"]["space_id"] == daemon.app.search_engine.provider.space_id
    texts = ["raft consensus snapshot", "merkle tree diff", "", "zstd page cache " * 20]
    got = c.call("embed_batch", texts=texts, model=model, max_batch_tokens=16)
    assert got["dim"] == want.dim and got["batches"] >= 2
    np.testing.assert_allclose(np.asarray(got["vectors"], np.float32), want.encode(texts),
                               atol=0 if model == "mock" else 1e-5, rtol=0)
    assert c.call("model_unload", model=model) == {"unloaded": True}
    assert c.call("model_status")["loaded"] == []


@pytest.mark.parametrize("rtype", ["repair", "doctor", "repair_dry_run"])
def test_repair_and_doctor_answer_as_the_reference(daemon, tree, tmp_path, rtype,
                                                   reference_native):
    """`repair` (with and without dry_run) and `doctor` through the socket
    answer as the reference's RepairService on an AppContext over the same
    tree, apart from the repair service's named departures (the binary,
    'skipped', document is not re-queued; doctor's device and native lines
    are the port's own). The reference's native library is built into a
    file of the test's own (`reference_native`), so its doctor line does
    not depend on which xdist worker won its loader's shared build."""
    from test_torch_services import ref_config_for
    from yams_tpu.services.app import AppContext as RefApp
    from yams_tpu.services.repair_service import RepairService as RefRepair

    ref_app = RefApp(ref_config_for(tmp_path / "ref"))
    try:
        populate(ref_app, tree)
        daemon.client.add_path(str(tree))
        _add_tagged(daemon.client)
        svc = RefRepair(ref_app)
        if rtype == "repair":
            got, want = daemon.client.repair(), svc.run()
            assert not any(v.startswith("failed") for v in got.values())
            assert got.pop("embeddings") == "0 documents embedded"
            assert want.pop("embeddings").endswith("(1 re-queued from lost index)")
            assert got == want and "clusters over" in got["topology"]
            assert daemon.app.search_engine.topology is not None
        else:
            if rtype == "doctor":
                got = daemon.client.doctor()
                want = {k: list(v) for k, v in svc.doctor().items()}
            else:
                res = daemon.client.call("repair", dry_run=True, ops=["topology", "nope"])
                assert res["dry_run"] and res["plan"] == {"topology": "planned",
                                                          "nope": "unknown op"}
                assert daemon.app.search_engine.topology is None   # nothing ran
                got = {k: [v["ok"], v["detail"]] for k, v in res["doctor"].items()}
                want = {k: list(v) for k, v in svc.doctor().items()}
            assert got.pop("device") == [True, "cpu"] and want.pop("device")[0]
            assert got.pop("native_lib")[0] == want.pop("native_lib")[0]
            norm = lambda d, root: {k: [ok, str(det).replace(str(root), "<dir>")]  # noqa: E731
                                    for k, (ok, det) in d.items()}
            assert norm(got, daemon.app.config.data_dir) == norm(want, ref_app.config.data_dir)
    finally:
        ref_app.close()


def test_a_session_filter_answers_unsupported(daemon):
    """The `session` search filter, UNSUPPORTED until the session service was
    ported, restricts a search through the socket to the pinned documents,
    as it does in-process."""
    c = daemon.client
    _add_tagged(c)
    assert c.call("session", op="pin", pattern="*t[1-3].txt", name="s") == {"ok": True}
    assert c.call("session", op="warm", name="s") == {"warmed": 3}
    got = c.call("search", query="raft", search_type="fts", filters={"session": "s"})
    want = daemon.app.search.search("raft", search_type="fts", filters={"session": "s"})
    assert [(h["document_id"], h["path"]) for h in got["hits"]] == \
        [(h.document_id, h.path) for h in want.hits]
    assert sorted(h["name"] for h in got["hits"]) == ["t1.txt", "t2.txt", "t3.txt"]


def test_trusted_plugins_are_reported_not_loaded(tmp_path, short_dir):
    """Trusted plugins autoload at start (they were reported as not loaded
    until plugins were ported): the bundled NER plugin loads by its path on
    the daemon's device and reports ok, the daemon is not degraded by it,
    and the graph service's entities are then the NER model's. A trusted
    path that does not exist is skipped."""
    ner = REPO / "yams_tpu_torch" / "plugins" / "neural_ner.py"
    cfg = daemon_config(tmp_path / "data", short_dir)
    cfg.data_dir.mkdir(parents=True)
    (cfg.data_dir / "plugins_trust.txt").write_text(f"{ner}\n{tmp_path / 'missing.py'}\n")
    d = ThreadDaemon(cfg, CPU, timeout=120)
    try:
        st = d.client.status()
        assert not any(k.startswith("plugin") for k in st.get("degraded", {}))
        got = d.client.call("plugins", op="list")
        assert got["health"] == {"neural_ner": {"status": "ok", "labels": ["entity"]}}
        assert [p["name"] for p in got["plugins"]] == ["neural_ner"]
        assert [e for e, _ in d.app.graph.extract_entities(
            "When the CacheManager runs the ingest_queue_worker")] == \
            ["CacheManager", "ingest_queue_worker"]
        assert d.daemon.plugins.trusted_paths() == [ner, tmp_path / "missing.py"]
    finally:
        d.stop()


def test_a_trusted_plugin_that_fails_to_load_degrades_the_daemon(tmp_path, short_dir):
    """A trusted plugin whose init raises is not loaded, and the daemon
    starts DEGRADED naming it with the error, instead of serving as READY
    with the graph stage quietly back on the heuristic extractor."""
    bad = tmp_path / "yams_plugin_broken.py"
    bad.write_text(
        "from yams_tpu_torch.plugins.spec import ABI_VERSION, PluginManifest\n"
        "def init(config):\n"
        "    raise RuntimeError('no card for the tagger')\n"
        "def yams_plugin():\n"
        "    return PluginManifest(name='broken', version='1', abi_version=ABI_VERSION,\n"
        "                          init=init)\n")
    cfg = daemon_config(tmp_path / "data", short_dir)
    cfg.data_dir.mkdir(parents=True)
    (cfg.data_dir / "plugins_trust.txt").write_text(f"{bad}\n")
    d = ThreadDaemon(cfg, CPU, timeout=120)
    try:
        st = d.client.status()
        assert st["state"] == "degraded"
        assert st["degraded"]["plugin:yams_plugin_broken"] == \
            "RuntimeError: no card for the tagger"
        assert d.client.call("plugins", op="list")["health"] == {}
    finally:
        d.stop()


def test_spawn_daemon_starts_the_ports_module(tmp_path, monkeypatch):
    seen = {}

    class FakePopen:
        pid = 4242

        def __init__(self, args, **kw):
            seen["args"], seen["env"] = args, kw["env"]
            pathlib.Path(cfg.socket_path).touch()

    cfg = port_config_for(tmp_path / "data")
    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    assert spawn_daemon(cfg, device="cpu") == 4242
    assert seen["args"] == [sys.executable, "-m", "yams_tpu_torch.daemon", "--device", "cpu"]
    assert seen["env"]["YAMS_TPU_STORAGE"] == str(cfg.data_dir)


def test_daemon_module_runs_on_the_device_it_is_given(short_dir):
    proc = subprocess.Popen(
        [sys.executable, "-m", "yams_tpu_torch.daemon", str(short_dir), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env=dict(os.environ, YAMS_VECTOR_SHARDED="off"))
    try:
        client = DaemonClient(load_config(data_dir=short_dir).socket_path)
        deadline = time.monotonic() + 120
        while not client.ping(timeout=2.0):
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline
            time.sleep(0.2)
        assert client.call("ping")["device"] == "cpu"
        client.shutdown()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
