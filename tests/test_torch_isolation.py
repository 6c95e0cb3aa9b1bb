"""The port stands alone: yams_tpu_torch imports nothing of yams_tpu.

- In a fresh interpreter whose import system refuses `yams_tpu`, `jax`,
  `jaxlib`, `flax` and `optax` (a `sys.meta_path` finder that raises
  ModuleNotFoundError for them and their submodules), every module of
  yams_tpu_torch (the package walked), `chip_smoke`, the two top-C
  experiments and the six design experiments import, and a tiny add -> search runs on the CPU: device
  chunk + hash, a ContentStore round trip, and SearchEngine searches
  (with an intent, so search/query.py runs; with feedback; on the int8
  tier), and the KG leg over the port's own SQLite store with the tuner,
  then the indexes saved and reopened, and the hf provider with the
  ColBERT tier and the fragment arm; then the service layer: an
  AppContext on the CPU adds and searches, and the port's daemon answers a
  ping over its socket.
- Statically, no file under yams_tpu_torch/ (nor chip_smoke.py) names
  yams_tpu in an import statement or in an importlib / __import__ call.
- Every entry point runs on the card unless the caller asks for the CPU:
  with no `device` argument (the CLI: no `--device`) each resolves to CUDA,
  which raises here, where torch sees no card; with device="cpu" each runs.
  The entry points: SearchEngine, ContentStore, VectorIndex, SimeonProvider,
  AppContext, YamsDaemon, the CLI, TopologyEngine, the hf, neural and mock
  providers, TokenIndex, NerModel (and its fit), LexicalIndex.search,
  `python -m yams_tpu_torch.mcp`, the encoders' ContrastiveTrainer and the
  real-text `run_eval`.
- The service slice (grep, sessions, watch, downloads and a remote
  checkpoint, the NER plugin with its pickle, MCP, auth and the standalone
  BM25 scan) runs on the CPU with the reference refused.
- The six design experiments (profile_vec, exp_coarse_bf16,
  exp_recall_target, profile_bm25, profile_bm25b, profile_lex_stages) run
  a tiny CPU pass each with the reference refused.
- The training and real-text slice (the stand-in root, the real-text
  dataset, `NerModel.fit`, the contrastive trainer, the `.npz` writer and
  the scripts' `main`s at a tiny size) runs on the CPU with the reference
  and optax refused.
"""

import ast
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
REFUSED = ("yams_tpu", "jax", "jaxlib", "flax", "optax")
DESIGN_EXPERIMENTS = ("profile_vec", "exp_coarse_bf16", "exp_recall_target", "profile_bm25",
                      "profile_bm25b", "profile_lex_stages")

_GUARD = f"""
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {REFUSED!r}:
            raise ModuleNotFoundError(f"refused: {{name}}", name=name)
        return None

sys.meta_path.insert(0, _Refuse())
"""


def _run_guarded(code: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD + textwrap.dedent(code)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_imports_and_runs_with_the_reference_refused(tmp_path):
    out = _run_guarded(f"""
        import importlib, pkgutil
        import numpy as np
        import torch
        import yams_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(yams_tpu_torch.__path__,
                                                      "yams_tpu_torch.")]
        for name in names + ["chip_smoke", "yams_tpu_torch.scripts.profile_grouped",
                             "yams_tpu_torch.scripts.exp_flash_topk",
                             *("yams_tpu_torch.scripts." + n for n in {DESIGN_EXPERIMENTS!r})]:
            importlib.import_module(name)
        from yams_tpu_torch.core.config import ChunkingConfig
        from yams_tpu_torch.ingest.device_pipeline import device_chunk_hash
        from yams_tpu_torch.search.engine import SearchEngine
        from yams_tpu_torch.storage.content_store import ContentStore
        cpu = torch.device("cpu")
        data = np.random.default_rng(0).bytes(20_000)
        trip = device_chunk_hash(data, 256, 1024, 4096, cpu)
        assert trip[0][1] == 0 and trip[-1][2] == len(data)
        cs = ContentStore({str(tmp_path)!r}, ChunkingConfig(256, 1024, 4096), device=cpu)
        res = cs.store_bytes(data)
        assert cs.retrieve_bytes(res.content_hash) == data
        cs.close()
        eng = SearchEngine(device=cpu)
        eng.add_documents([(1, "thread scheduler preempts", "sched"),
                           (2, "chunk hashing and dedup", "cas")])
        hits = eng.search_batch(["scheduler", "dedup chunk"])
        assert hits[0][0].doc_id == 1 and hits[1][0].doc_id == 2
        # intent weights (search/query.py), the hotzone and the int8 tier
        eng.record_feedback(2)
        hits = eng.search_batch(["how are threads preempted"], intent="question")
        assert eng.last_trace["intent"] == "question" and hits[0]
        from yams_tpu_torch.core.config import VectorIndexConfig
        q8 = SearchEngine(vector=VectorIndexConfig(dtype="int8"), device=cpu)
        q8.add_documents([(1, "thread scheduler preempts", "sched")])
        assert q8.search("scheduler")[0].doc_id == 1
        # the KG leg over the port's own SQLite store, the tuner, and the
        # indexes saved and reopened
        from yams_tpu_torch.index.lexical_index import LexicalIndex
        from yams_tpu_torch.index.vector_index import VectorIndex
        from yams_tpu_torch.metadata import Database, KnowledgeGraphStore
        from yams_tpu_torch.search.tuner import SearchTuner
        db = Database({str(tmp_path / "m.db")!r})
        db.execute("INSERT INTO documents (id, file_path, file_name, sha256_hash,"
                   " created_time, modified_time, indexed_time) VALUES (1,'/a','a','0',0,0,0)")
        kg = KnowledgeGraphStore(db)
        kgeng = SearchEngine(kg_store=kg, device=cpu)
        kgeng.tuner = SearchTuner()
        kgeng.add_documents([(1, "thread scheduler preempts", "sched"),
                             (2, "chunk hashing and dedup", "cas")])
        node = kg.upsert_node("entity:preemption", label="preemption")
        kg.add_alias(node, "preemption")
        kg.link_document(1, node, "preemption", 0.9)
        kgeng.add_entity_vectors([node], ["preemption"])
        hit = kgeng.search("preemption")[0]
        assert hit.doc_id == 1 and hit.kg_score > 0
        kgeng.record_feedback(1)
        kgeng.vector_index.save({str(tmp_path / "idx")!r})
        kgeng.lexical_index.save({str(tmp_path / "idx")!r})
        kgeng.vector_index = VectorIndex.load({str(tmp_path / "idx")!r}, device=cpu)
        kgeng.lexical_index = LexicalIndex.load({str(tmp_path / "idx")!r})
        assert kgeng.search("preemption")[0].doc_id == 1
        # the hf provider with the ColBERT tier and the fragment arm
        from yams_tpu_torch.embed.provider import create_provider
        hfeng = SearchEngine(provider=create_provider("hf", device=cpu), device=cpu)
        hfeng.enable_late_interaction()
        hfeng.enable_fragment_geometry()
        hfeng.add_documents([(1, "the merkle tree diff detects renamed files. It compares hashes.", ""),
                             (2, "packet routing fabric forwards frames. Switches learn.", "")])
        assert hfeng.search("merkle tree diff")[0].doc_id == 1
        assert {{"late_interaction_ms", "fragment_geometry_ms"}} <= set(hfeng.last_trace["stages"])
        # the service layer: AppContext add -> search, and a daemon ping
        import asyncio, threading, time
        from yams_tpu_torch.core.config import load_config
        from yams_tpu_torch.daemon.client import DaemonClient
        from yams_tpu_torch.daemon.server import YamsDaemon
        from yams_tpu_torch.services.app import AppContext
        app = AppContext(load_config(data_dir={str(tmp_path / "app")!r}), device="cpu")
        app.documents.add_bytes(b"thread scheduler preempts", "sched.txt")
        app.documents.add_bytes(b"chunk hashing and dedup", "cas.txt")
        assert app.search.search("scheduler").hits[0].path == "/sched.txt"
        app.close()
        cfg = load_config(data_dir={str(tmp_path / "app")!r})
        daemon, loop = YamsDaemon(cfg, device="cpu"), asyncio.new_event_loop()
        th = threading.Thread(target=lambda: loop.run_until_complete(daemon.run()))
        th.start()
        client = DaemonClient(cfg.socket_path)
        deadline = time.monotonic() + 60
        while not client.ping(timeout=2.0):
            assert th.is_alive() and time.monotonic() < deadline
            time.sleep(0.1)
        assert client.call("ping")["backend"] == "torch"
        assert client.search("dedup chunk")["hits"][0]["path"] == "/cas.txt"
        client.shutdown()
        th.join(timeout=60)
        assert not th.is_alive()
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in {REFUSED!r})
        print(len(names), loaded)
    """)
    n, loaded = out.split(maxsplit=1)
    assert int(n) >= 30 and loaded.strip() == "[]"


def test_repair_then_shadow_search_with_the_reference_refused(tmp_path):
    """The topology and repair slice in a fresh interpreter that refuses the
    reference: the new modules import, a CPU AppContext is repaired (every
    op, none failed; doctor green), and a search under the default shadow
    policy then routes through the repaired topology."""
    out = _run_guarded(f"""
        import importlib
        for name in ("yams_tpu_torch.index.topology", "yams_tpu_torch.utils.tda",
                     "yams_tpu_torch.services.repair_service",
                     "yams_tpu_torch.storage.compression_recovery",
                     "yams_tpu_torch.scripts.bench_narrow"):
            importlib.import_module(name)
        from yams_tpu_torch.core.config import load_config
        from yams_tpu_torch.services.app import AppContext
        from yams_tpu_torch.services.repair_service import RepairService
        app = AppContext(load_config(data_dir={str(tmp_path / "app")!r}), device="cpu")
        for i in range(12):
            app.documents.add_bytes(f"note {{i}} on thread scheduler preemption".encode(),
                                    f"n{{i}}.txt")
        app.documents.add_bytes(b"chunk hashing and dedup", "cas.txt")
        report = RepairService(app).run()
        assert not [op for op, r in report.items() if r.startswith("failed")], report
        assert all(ok for ok, _ in RepairService(app).doctor().values())
        eng = app.search_engine
        assert eng.config.topology_policy == "shadow" and eng.topology is not None
        assert app.search.search("scheduler").hits
        assert "shadow_agreement" in eng.last_trace and eng.stats()["topology_routes"] > 0
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in {REFUSED!r})
        print(report["topology"], loaded)
    """)
    assert "clusters over" in out and out.strip().endswith("[]")


def test_the_service_slice_runs_with_the_reference_refused(tmp_path):
    """Grep, sessions, watch, downloads with a remote checkpoint, the NER
    plugin (its pickle loaded), MCP, auth and the standalone BM25 scan in a
    fresh interpreter that refuses yams_tpu, jax, jaxlib and flax."""
    out = _run_guarded(f"""
        import io, json, pathlib
        import torch
        from yams_tpu_torch.cli.auth import AuthStore
        from yams_tpu_torch.core.config import load_config
        from yams_tpu_torch.embed.ner import NerModel
        from yams_tpu_torch.mcp.server import run_stdio_server
        from yams_tpu_torch.ops.bm25 import bm25_dense
        from yams_tpu_torch.plugins.manager import PluginManager
        from yams_tpu_torch.services.app import AppContext
        from yams_tpu_torch.storage.backends import FilesystemBackend
        from yams_tpu_torch.storage.remote_checkpoint import (DRProvider, restore_checkpoint,
                                                              spill_checkpoint)
        root = pathlib.Path({str(tmp_path)!r})
        app = AppContext(load_config(data_dir=root / "app"), device="cpu")
        pm = PluginManager(app, trust_file=root / "app" / "plugins_trust.txt")
        pm.trust(pathlib.Path("yams_tpu_torch/plugins/neural_ner.py").resolve())
        assert pm.load_trusted() == 1 and pm.health()["neural_ner"]["status"] == "ok"
        (root / "w").mkdir()
        (root / "w" / "a.txt").write_text("the CacheManager runs a scheduler")
        assert [e.kind for e in app.watch.run_once(root / "w")] == ["added"]
        assert app.grep.grep("scheduler").matches
        app.sessions.pin("*/w/*", "s")
        assert app.sessions.warm("s") == 1
        (root / "blob.bin").write_bytes(b"downloaded bytes " * 100)
        assert app.downloads.download((root / "blob.bin").as_uri()).document_id > 0
        assert app.search.search("scheduler", filters={{"session": "s"}}).hits
        hits = app.search_engine.lexical_index.search("scheduler", device="cpu")
        assert hits
        app.checkpoint()
        b = FilesystemBackend(root / "remote")
        spill_checkpoint(app.config.data_dir, b, "ck", epoch=1)
        assert DRProvider(b).verify_sample("ck").passed
        restore_checkpoint(b, root / "restored")
        out = io.StringIO()
        run_stdio_server(app, stdin=io.StringIO(json.dumps({{"jsonrpc": "2.0", "id": 1,
            "method": "tools/call", "params": {{"name": "grep",
            "arguments": {{"pattern": "CacheManager"}}}}}}) + "\\n"), stdout=out)
        assert "CacheManager" in out.getvalue()
        AuthStore(root / "app").keygen("hmac", name="k")
        app.close()
        ner = NerModel.load("yams_tpu_torch/plugins/data/ner_default.pkl", device="cpu")
        assert [e for e, *_ in ner.extract("the CacheManager runs")] == ["CacheManager"]
        t = lambda *a: [torch.tensor(x) for x in a]
        args = t([[1, 0]], [[1.0, 1.0]], [0, 1, 2, 1, 3, 3], [1.0, 2.0, 1.0, 1.0, 0.0, 0.0],
                 [0, 1], [1, 3], [1.0, 0.9, 1.1], [0.5, 1.5])
        a = bm25_dense(*args, window=2, num_docs=3)
        part = lambda idf, tf, dn: idf * tf * 2.2 / (tf + 1.2 * dn)
        want = [part(0.5, 1.0, 1.0), part(1.5, 2.0, 0.9), part(1.5, 1.0, 1.1)]
        assert torch.allclose(a, torch.tensor([want]))
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in {REFUSED!r})
        print(loaded)
    """)
    assert out.strip() == "[]"


def test_the_training_slice_runs_with_the_reference_refused(tmp_path):
    """Every module and script of the training and real-text slice, and the
    scripts' mains at a tiny size on the CPU (train_encoder's trainer
    through train_encoder_realtext's: its own main needs more steps than
    its 50-step warmup), with yams_tpu, jax, jaxlib, flax and optax
    refused."""
    out = _run_guarded(f"""
        import contextlib, importlib, io, os, pathlib
        import numpy as np
        import torch
        torch.set_num_threads(2)    # this interpreter only: the suite runs in parallel
        for name in ("utils.metrics", "utils.beir", "utils.optim", "scripts.realtext",
                     "scripts.train_ner_default", "scripts.eval_ner_realtext",
                     "scripts.train_encoder", "scripts.train_encoder_realtext",
                     "scripts.eval_beir_scale"):
            importlib.import_module("yams_tpu_torch." + name)
        from yams_tpu_torch.embed.ner import NerConfig, NerModel
        from yams_tpu_torch.embed.provider import HFProvider
        from yams_tpu_torch.scripts import (eval_beir_scale, eval_ner_realtext, realtext,
                                            train_encoder, train_encoder_realtext,
                                            train_ner_default)
        tmp = pathlib.Path({str(tmp_path)!r})
        root = realtext.assemble_root(tmp / "root", 12)["root"]
        ds = realtext.realtext_beir(root=root)
        assert ds.queries and set(ds.kinds.values()) == {{"heading", "symbol"}}
        m = NerModel(NerConfig(dm=16, heads=2, layers=1, window=8), device="cpu")
        losses = []
        m.fit([(["the", "CacheManager", "runs"], [0, 1, 0])] * 4, steps=3, losses=losses)
        assert len(losses) == 3
        sink = io.StringIO()
        with contextlib.redirect_stdout(sink):
            train_ner_default.main([str(tmp / "ner.pkl"), "2", "--device", "cpu"])
            eval_ner_realtext.main(["--root", str(root), "--checkpoint", str(tmp / "ner.pkl"),
                                    "--device", "cpu"])
            os.environ.update(ENC_DIM="16", ENC_LAYERS="1", ENC_HEADS="2")
            train_encoder_realtext.main([str(tmp / "rt.npz"), "2", "--root", str(root),
                                         "--device", "cpu"])
            eval_beir_scale.main(["hf", str(tmp / "rt.npz"), "--root", str(root),
                                  "--modes", "hybrid,hybrid+colbert", "--device", "cpu"])
        text = sink.getvalue()
        assert "span_f1" in text and "saved" in text and '"hybrid+colbert"' in text, text
        assert HFProvider(str(tmp / "rt.npz"), device="cpu").dim == 16
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in {REFUSED!r})
        print(loaded)
    """)
    assert out.strip().endswith("[]")


def test_the_sharded_slice_runs_with_the_reference_refused(tmp_path):
    """The scale-out slice (parallel/, the sharded engine route, sharded
    checkpoints) and the dryrun script on a virtual mesh of CPU shards,
    with yams_tpu, jax, jaxlib, flax and optax refused."""
    out = _run_guarded(f"""
        import contextlib, io
        import torch
        from yams_tpu_torch.index.checkpoint import (restore_sharded, save_sharded,
                                                     sharded_template)
        from yams_tpu_torch.parallel.mesh import virtual_mesh
        from yams_tpu_torch.scripts import dryrun_multichip
        sink = io.StringIO()
        with contextlib.redirect_stdout(sink):
            assert dryrun_multichip.main(["8", "--device", "cpu"]) == 0
        assert sink.getvalue().startswith("dryrun_multichip ok: virtual mesh of 8"), sink.getvalue()
        x = torch.arange(64.0).reshape(16, 4)
        save_sharded({str(tmp_path / "ck")!r}, {{"x": x.chunk(4)}}, epoch=2)
        got, epoch = restore_sharded({str(tmp_path / "ck")!r}, {{"x": sharded_template(
            x, virtual_mesh(2, "d", "cpu"), ("d", None))}})
        assert epoch == 2 and torch.equal(torch.cat(got["x"]), x)
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in {REFUSED!r})
        print(loaded)
    """)
    assert out.strip().endswith("[]")


NEW_SCRIPTS = ("bench_ipc_ceiling", "bench_daemon", "relevance_ab", "bench_ingest",
               "bench_ingest_device", "bench_encode", "bench_pq", "profile_legs")


def test_the_mobile_abi_and_the_measurement_scripts_run_with_the_reference_refused(tmp_path):
    """The mobile C ABI's loader (`native.mobile_library()`, built and
    bound) answers its version and talks to the port's daemon over its
    socket, and every measurement script of the slice imports; three run a
    tiny CPU pass (profile_legs, bench_encode, relevance_ab's sign test);
    with yams_tpu, jax, jaxlib, flax and optax refused."""
    out = _run_guarded(f"""
        import contextlib, ctypes, importlib, io, json, os
        import torch
        from yams_tpu_torch import native
        from yams_tpu_torch.core import config as C
        from chip_smoke import ThreadDaemon
        for name in {NEW_SCRIPTS!r}:
            importlib.import_module("yams_tpu_torch.scripts." + name)
        from yams_tpu_torch.scripts import bench_encode, profile_legs, relevance_ab
        lib = native.mobile_library()
        assert lib.yams_mobile_abi_version() == 1
        cfg = C.Config(data_dir=__import__("pathlib").Path({str(tmp_path / "d")!r}))
        cfg.embedding = C.EmbeddingConfig(dim=64, sketch_dim=512)
        cfg.vector = C.VectorIndexConfig(dim=64, capacity=256, block_rows=128)
        cfg.daemon.socket_path = {str(tmp_path / "s.sock")!r}
        d = ThreadDaemon(cfg, torch.device("cpu"), timeout=120)
        h = lib.yams_mobile_connect(str(cfg.socket_path).encode())
        ptr = lib.yams_mobile_ping(h)
        pong = json.loads(ctypes.string_at(ptr))
        lib.yams_mobile_free(ptr)
        lib.yams_mobile_disconnect(h)
        d.stop()
        assert pong["result"]["backend"] == "torch", pong
        os.environ.update(BENCH_N="2048", BENCH_D="32", BENCH_B="4", BENCH_ITERS="1")
        with contextlib.redirect_stdout(io.StringIO()):
            assert len(profile_legs.main(["--device", "cpu"])) == 5
            assert bench_encode.main(["--docs", "8", "--reps", "1", "--device", "cpu"])[
                "embeddings"].shape == (8, 384)
        assert relevance_ab.sign_test([0.1] * 8) < 0.01
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in {REFUSED!r})
        print(loaded)
    """)
    assert out.strip().endswith("[]")


def test_the_design_experiments_run_with_the_reference_refused():
    """The six design experiments import and each run() does a tiny CPU
    pass, with yams_tpu, jax, jaxlib, flax and optax refused."""
    out = _run_guarded(f"""
        import contextlib, importlib, io
        mods = {{n: importlib.import_module("yams_tpu_torch.scripts." + n)
                for n in {DESIGN_EXPERIMENTS!r}}}
        with contextlib.redirect_stdout(io.StringIO()):
            runs = [
                mods["profile_vec"].run(N=2048, D=32, B=4, iters=1, D0=8, device="cpu"),
                mods["exp_coarse_bf16"].run(N=4096, D=32, B=4, iters=1, n_clusters=32,
                                            device="cpu"),
                mods["exp_recall_target"].run(N=4096, D=32, B=4, iters=1, n_clusters=32,
                                              groups=(16, 64), device="cpu"),
                mods["profile_bm25"].run(N=4096, B=4, iters=1, T=4, vocab=64, window=64,
                                         device="cpu"),
                mods["profile_bm25b"].run(N=4096, B=4, iters=1, T=4, vocab=64, window=64,
                                          device="cpu"),
                mods["profile_lex_stages"].run(B=4, T=4, W=64, V=128, reps=1, device="cpu"),
            ]
        assert [r["experiment"] for r in runs] == list({DESIGN_EXPERIMENTS!r})
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in {REFUSED!r})
        print(loaded)
    """)
    assert out.strip().endswith("[]")


def test_the_guard_refuses_the_reference():
    """The finder above does refuse: importing yams_tpu through it fails."""
    proc = subprocess.run([sys.executable, "-c", _GUARD + "import yams_tpu.core.config"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "refused: yams_tpu" in proc.stderr


_NAMES_REFERENCE = re.compile(r"\byams_tpu\b(?!_torch)")


def _import_targets(tree: ast.AST):
    """Module names in import statements and string arguments of importlib /
    __import__ calls."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call):
            func = ast.unparse(node.func)
            if func.startswith("importlib") or func in ("__import__", "import_module"):
                for arg in [*node.args, *(k.value for k in node.keywords)]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                            yield sub.value


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "yams_tpu_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_no_file_names_yams_tpu_in_an_import(path):
    tree = ast.parse((REPO / path).read_text())
    bad = [t for t in _import_targets(tree) if _NAMES_REFERENCE.search(t)
           or t.split(".")[0] in REFUSED[1:]]
    assert not bad, bad


def _search_engine(device):
    from yams_tpu_torch.search.engine import SearchEngine
    eng = SearchEngine() if device is None else SearchEngine(device=device)
    eng.add_documents([(1, "thread scheduler", "t")])
    assert eng.search("scheduler")[0].doc_id == 1
    return eng.device


def _content_store(device, root):
    from yams_tpu_torch.storage.content_store import ContentStore
    cs = ContentStore(root) if device is None else ContentStore(root, device=device)
    h = cs.store_bytes(b"payload " * 100).content_hash
    assert cs.retrieve_bytes(h) == b"payload " * 100
    cs.close()
    return cs.device


def _vector_index(device):
    from yams_tpu_torch.index.vector_index import VectorIndex
    kw = {} if device is None else {"device": device}
    idx = VectorIndex(dim=16, capacity=128, block_rows=64, **kw)
    v = np.eye(16, dtype=np.float32)
    idx.add(v, list(range(16)))
    assert idx.search(v[3], k=1)[1][0, 0] == 3
    return idx.device


def _provider(device):
    from yams_tpu_torch.embed.provider import SimeonProvider
    p = SimeonProvider() if device is None else SimeonProvider(device=device)
    assert p.encode(["hello world"]).shape == (1, p.dim)
    return p.device


def _app_context(device, root):
    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.services.app import AppContext
    cfg = load_config(data_dir=root)
    app = AppContext(cfg) if device is None else AppContext(cfg, device=device)
    app.documents.add_bytes(b"thread scheduler", "t.txt")
    assert app.search.search("scheduler").hits[0].path == "/t.txt"
    app.close()
    return app.device


def _daemon(device, root):
    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.daemon.server import YamsDaemon
    cfg = load_config(data_dir=root)
    return (YamsDaemon(cfg) if device is None else YamsDaemon(cfg, device=device)).device


def _cli(device, root):
    import contextlib
    import io
    import json
    from yams_tpu_torch.cli.main import main
    argv = ["--storage", str(root), "--no-daemon", "--json", "status", "--detailed"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv if device is None else ["--device", device, *argv])
    assert rc == 0
    return torch.device(json.loads(out.getvalue())["devices"][0])


def _hf_provider(device):
    from yams_tpu_torch.embed.provider import HFProvider
    p = HFProvider() if device is None else HFProvider(device=device)
    assert p.encode(["hello world"]).shape == (1, p.dim)
    return p.device


def _neural_provider(device):
    from yams_tpu_torch.embed.provider import NeuralProvider
    kw = {"dim": 48, "max_len": 32}
    p = NeuralProvider(**kw) if device is None else NeuralProvider(**kw, device=device)
    assert p.encode(["hello world"]).shape == (1, 48)
    return p.device


def _mock_provider(device):
    from yams_tpu_torch.embed.provider import MockProvider
    p = MockProvider() if device is None else MockProvider(device=device)
    assert p.query_device_inputs(["hello"])[1].device.type == p.device.type
    return p.device


def _token_index(device):
    from yams_tpu_torch.index.token_index import TokenIndex
    idx = TokenIndex(dim=8) if device is None else TokenIndex(dim=8, device=device)
    idx.set_doc(0, np.eye(8, dtype=np.float32)[:3])
    assert idx.gather(torch.zeros((1, 1), dtype=torch.int64))[1].sum() == 3
    return idx.device


def _topology_engine(device):
    from yams_tpu_torch.index.topology import TopologyEngine
    eng = TopologyEngine() if device is None else TopologyEngine(device=device)
    v = np.eye(16, dtype=np.float32)
    assert len(eng.build(v, np.ones(16, np.float32)).assignments) == 16
    return eng.device


def _ner_model(device):
    from yams_tpu_torch.embed.ner import NerConfig, NerModel
    m = NerModel(NerConfig(window=8)) if device is None else \
        NerModel(NerConfig(window=8), device=device)
    assert m.tag(["a", "B"])[0].shape == (2,)
    return m.device


def _ner_fit(device):
    from yams_tpu_torch.embed.ner import NerConfig, NerModel
    m = NerModel(NerConfig(dm=8, heads=2, layers=1, window=4)) if device is None else \
        NerModel(NerConfig(dm=8, heads=2, layers=1, window=4), device=device)
    assert np.isfinite(m.fit([(["a", "B"], [0, 1])], steps=1))
    return m.device


def _contrastive_trainer(device):
    from yams_tpu_torch.embed.hf_encoder import init_params
    from yams_tpu_torch.scripts.train_encoder import ContrastiveTrainer
    p = init_params(np.random.default_rng(0), 8, dim=8, layers=1, intermediate=8, max_len=4)
    kw = {"heads": 2, "steps": 2, "warmup": 1}
    t = ContrastiveTrainer(p, **kw) if device is None else \
        ContrastiveTrainer(p, **kw, device=device)
    ids = np.array([[2, 5, 3, 0], [2, 6, 3, 0]])
    attn = (ids > 0).astype(np.float32)
    assert torch.isfinite(t.step((ids, attn, ids, attn)))
    return t.device


def _run_eval(device):
    from yams_tpu_torch.scripts.eval_beir_scale import run_eval
    from yams_tpu_torch.utils.beir import BeirDataset
    ds = BeirDataset("t", {"a.md#0": {"title": "", "text": "thread scheduler preempts"}},
                     {"q0": "thread scheduler"}, {"q0": {"a.md#0": 1}})
    ds.kinds = {"q0": "heading"}
    out = run_eval(modes=("hybrid",), quiet=True, ds=ds) if device is None else \
        run_eval(modes=("hybrid",), quiet=True, ds=ds, device=device)
    assert out["hybrid"]["all"]["mrr"] == 1.0
    return torch.device(device)


def _lexical_search(device):
    from yams_tpu_torch.index.lexical_index import LexicalIndex
    idx = LexicalIndex()
    idx.add_document(0, "thread scheduler")
    hits = idx.search("scheduler") if device is None else idx.search("scheduler", device=device)
    assert hits[0][0] == 0
    return torch.device(device or "cuda")


def _corpus_mesh(device):
    from yams_tpu_torch.parallel import corpus_mesh
    return corpus_mesh(**({} if device is None else {"device": device})).lead


def _dryrun(device):
    import contextlib
    import io
    from yams_tpu_torch.scripts.dryrun_multichip import dryrun_multichip
    with contextlib.redirect_stdout(io.StringIO()):
        dryrun_multichip(2, **({} if device is None else {"device": device}))
    return torch.device(device or "cuda")


def _mcp_module(device, root):
    import contextlib
    import io
    import json
    import sys as _sys
    from yams_tpu_torch.mcp.__main__ import main
    argv = [str(root)] + ([] if device is None else ["--device", device])
    old, _sys.stdin = _sys.stdin, io.StringIO(json.dumps(
        {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
         "params": {"name": "status", "arguments": {}}}) + "\n")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
    finally:
        _sys.stdin = old
    assert json.loads(out.getvalue())["id"] == 1
    return torch.device(device or "cuda")


_ENTRY_POINTS = {"SearchEngine": _search_engine, "ContentStore": _content_store,
                 "VectorIndex": _vector_index, "SimeonProvider": _provider,
                 "AppContext": _app_context, "YamsDaemon": _daemon, "cli": _cli,
                 "TopologyEngine": _topology_engine, "HFProvider": _hf_provider,
                 "NeuralProvider": _neural_provider, "MockProvider": _mock_provider,
                 "TokenIndex": _token_index, "NerModel": _ner_model,
                 "NerModel.fit": _ner_fit, "ContrastiveTrainer": _contrastive_trainer,
                 "run_eval": _run_eval,
                 "LexicalIndex.search": _lexical_search, "mcp": _mcp_module,
                 "corpus_mesh": _corpus_mesh, "dryrun_multichip": _dryrun}
_TAKE_A_DIR = ("ContentStore", "AppContext", "YamsDaemon", "cli", "mcp")


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, tmp_path):
    def build(device):
        fn = _ENTRY_POINTS[name]
        return fn(device, tmp_path / str(device)) if name in _TAKE_A_DIR else fn(device)

    if torch.cuda.is_available():
        assert build(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build(None)
    assert build("cpu") == torch.device("cpu")
