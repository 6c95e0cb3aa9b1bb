"""The port's measurement scripts (yams_tpu_torch/scripts/) on the CPU, at
tiny sizes.

- bench_ipc_ceiling and bench_daemon (both modes) drive the port's daemon in
  a subprocess with `--device cpu` and print the reference scripts' JSON
  keys, with no request failing.
- relevance_ab: `run_queries` on the port's AppContext gives the reference
  script's rows (paths, nDCG, recall, reciprocal rank, first rank) and
  aggregate on the same corpus added through each package's AppContext;
  `diff` prints what the reference's prints for the same two files;
  `sign_test` equals the reference's; `main` writes a result file the
  reference's `diff` reads; beside the port's daemon it searches through
  the socket, and a daemon of the JAX package is refused.
- bench_ingest prints the reference's matrix through the port's ingest
  library, and where that library is off it exits 1 without a row.
- bench_ingest_device runs every stage's plain twin (the end-to-end chunks
  equal the host chunker's and hashlib's), bench_encode's embeddings equal
  the port's SimeonProvider and the reference's SimeonEncoder, bench_pq's
  K4 route (its twin here) and plain ADC route find the planted copies with
  recall within 0.01 of each other, and profile_legs times its five legs.
- Every script that runs in-process defaults to the card: without
  `--device cpu` it raises here, where torch sees no card. The six design
  experiments (tests/test_torch_design_experiments.py) are held to it here
  too.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from yams_tpu_torch.scripts import (bench_daemon, bench_encode, bench_ingest,
                                    bench_ingest_device, bench_ipc_ceiling, bench_pq,
                                    exp_coarse_bf16, exp_recall_target, profile_bm25,
                                    profile_bm25b, profile_lex_stages, profile_legs,
                                    profile_vec, relevance_ab)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _reference_script(name):
    """A reference script imported from scripts/ by path (once)."""
    import importlib.util

    mod = f"ref_script_{name}"
    if mod not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod, REPO / "scripts" / f"{name}.py")
        sys.modules[mod] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[mod])
    return sys.modules[mod]


def test_bench_ipc_ceiling_pings_the_ports_daemon(capsys):
    rows = bench_ipc_ceiling.main(["1,2", "40", "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows and [r["clients"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == {"op", "clients", "qps", "p50_ms", "errors"}
        assert r["op"] == "ping" and r["errors"] == 0 and r["qps"] > 0


@pytest.mark.parametrize("mode", ["threads", "pipelined"])
def test_bench_daemon_sweeps_the_ports_daemon(monkeypatch, capsys, mode):
    """Two client levels over a 40-document corpus, a quarter of the
    searches filtered; pipelined through the port's PipelinedDaemonClient."""
    monkeypatch.setenv("BD_MAX_BATCH", "8")
    if mode == "pipelined":
        monkeypatch.setenv("BD_MODE", "pipelined")
    else:
        monkeypatch.delenv("BD_MODE", raising=False)
    out = bench_daemon.main(["40", "4", "1,2", "0.25", "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == out
    assert out[0] == {"event": "seeded", "docs": 40, "ingest_s": out[0]["ingest_s"]}
    keys = {"clients", "qps", "p50_ms", "p95_ms", "errors", "batching"}
    if mode == "pipelined":
        keys |= {"mode", "conns"}
    for r, clients in zip(out[1:], (1, 2)):
        assert set(r) == keys and r["clients"] == clients and r["errors"] == 0
        assert r["batching"]["batched_requests"] > 0 and "latency_hist" not in r["batching"]


# -- relevance_ab ---------------------------------------------------------------

DOCS = [(b"the merkle tree snapshots track renames", "docs/tree.txt"),
        (b"garbage collection frees unreferenced blocks", "docs/gc.txt"),
        (b"a completely unrelated cooking recipe", "misc/food.txt"),
        (b"snapshots of the merkle tree are diffed by path", "docs/diff.txt"),
        (b"blocks are reference counted before collection", "docs/refs.txt")]
QUERIES = [{"query": "merkle snapshot renames", "relevant": ["tree.txt"]},
           {"query": "free unreferenced blocks", "relevant": ["gc.txt", "refs.txt"]},
           {"query": "cooking recipe", "relevant": ["food.txt"]},
           {"query": "tree path diff", "relevant": ["diff.txt", "nowhere.txt"]}]
SMALL_TOML = """
[embedding]
dim = 64
sketch_dim = 512

[vector]
dim = 64
capacity = 256
block_rows = 128

[lexical]
postings_window = 64
packed_max_entries = 0
"""


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """One small config file both packages read (XDG), and the same five
    documents added through each package's AppContext into its own dir."""
    from yams_tpu.core.config import load_config as ref_load
    from yams_tpu.services.app import AppContext as RefApp
    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.services.app import AppContext

    root = tmp_path_factory.mktemp("rel")
    (root / "xdg" / "yams_tpu").mkdir(parents=True)
    (root / "xdg" / "yams_tpu" / "config.toml").write_text(SMALL_TOML)
    mp = pytest.MonkeyPatch()
    mp.setenv("XDG_CONFIG_HOME", str(root / "xdg"))
    for var in ("YAMS_TPU_STORAGE", "YAMS_TPU_SOCKET"):
        mp.delenv(var, raising=False)
    port = AppContext(load_config(data_dir=root / "port"), device="cpu")
    ref = RefApp(ref_load(data_dir=root / "ref"))
    for app in (port, ref):
        try:
            for text, name in DOCS:
                app.documents.add_bytes(text, name)
        finally:
            app.close()
    yield {"port": str(root / "port"), "ref": str(root / "ref"), "root": root}
    mp.undo()


@pytest.fixture()
def xdg(corpora, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(corpora["root"] / "xdg"))
    for var in ("YAMS_TPU_STORAGE", "YAMS_TPU_SOCKET"):
        monkeypatch.delenv(var, raising=False)
    return corpora


def _rows(xdg):
    ref = _reference_script("relevance_ab")
    got = relevance_ab.run_queries(xdg["port"], QUERIES, 5, "hybrid", device="cpu")
    want = ref.run_queries(xdg["ref"], QUERIES, k=5, search_type="hybrid")
    return got, want


def test_relevance_rows_and_aggregate_match_the_reference(xdg):
    ref = _reference_script("relevance_ab")
    got, want = _rows(xdg)
    assert got == want
    assert relevance_ab.aggregate(got) == ref.aggregate(want)
    assert relevance_ab.aggregate(got)["mrr"] > 0.5 and got[0]["first_rank"] == 1


def test_relevance_diff_prints_what_the_reference_prints(xdg, tmp_path, capsys):
    ref = _reference_script("relevance_ab")
    got, _ = _rows(xdg)
    worse = [dict(r, ndcg=r["ndcg"] / 2, rr=r["rr"] / 2) for r in got]
    files = []
    for label, rows in (("base", got), ("cand", worse)):
        files.append(tmp_path / f"{label}.json")
        files[-1].write_text(json.dumps({"label": label, "k": 5, "type": "hybrid",
                                         "aggregate": relevance_ab.aggregate(rows),
                                         "rows": rows}))
    capsys.readouterr()
    assert relevance_ab.diff(*map(str, files)) == 0
    port_out = capsys.readouterr().out
    assert ref.diff(*map(str, files)) == 0
    assert port_out == capsys.readouterr().out and "paired sign test" in port_out


@pytest.mark.parametrize("deltas", [[0.1, 0.2, 0.05], [0.1] * 8, [], [0.0, 1e-13],
                                    [0.3, -0.1, 0.2, -0.4, 0.5, 0.6, -0.2]])
def test_sign_test_is_the_reference(deltas):
    assert relevance_ab.sign_test(deltas) == _reference_script("relevance_ab").sign_test(deltas)


def test_relevance_main_writes_what_the_reference_diffs(xdg, tmp_path, capsys):
    """`main` in-process (--device cpu) writes the result file; the
    reference's --diff reads it against itself: zero deltas, p = 1."""
    qf, out = tmp_path / "q.json", tmp_path / "run.json"
    qf.write_text(json.dumps(QUERIES))
    assert relevance_ab.main(["--storage", xdg["port"], "--queries", str(qf), "--k", "5",
                              "--label", "port", "--out", str(out), "--device", "cpu"]) == 0
    assert "[port] n=4" in capsys.readouterr().out
    res = json.loads(out.read_text())
    assert res["rows"] == _rows(xdg)[1] and res["aggregate"]["n"] == 4
    assert _reference_script("relevance_ab").diff(str(out), str(out)) == 0
    assert "p=1.0000 (not significant" in capsys.readouterr().out


def test_relevance_through_the_ports_daemon_and_not_the_references(xdg, tmp_path):
    """Beside the port's daemon the queries go through its socket (same
    rows); a daemon whose ping lacks "backend": "torch" is refused."""
    import socket
    import threading

    import torch

    from chip_smoke import ThreadDaemon
    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.core.errors import YamsError
    from yams_tpu_torch.daemon.protocol import read_frame, write_frame

    cfg = load_config(data_dir=xdg["port"])
    d = ThreadDaemon(cfg, torch.device("cpu"), timeout=120)
    try:
        got = relevance_ab.run_queries(xdg["port"], QUERIES, 5, "hybrid")
        assert got == _rows(xdg)[1] and d.daemon._requests_handled > len(QUERIES)
    finally:
        d.stop()
    # a stand-in for the JAX package's daemon: it answers ping without "backend"
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(str(cfg.socket_path))
    srv.listen(1)

    def answer():
        conn, _ = srv.accept()
        with conn:
            req = read_frame(conn)
            write_frame(conn, {"id": req.get("id"), "ok": True,
                               "result": {"pong": True, "state": "ready"}})

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    try:
        with pytest.raises(YamsError, match="not the torch port's"):
            relevance_ab.run_queries(xdg["port"], QUERIES, 5, "hybrid", device="cpu")
    finally:
        t.join(timeout=10)
        srv.close()
        cfg.socket_path.unlink(missing_ok=True)


# -- the device and host benchmarks ----------------------------------------------

def test_bench_ingest_prints_the_matrix_through_the_ingest_library(capsys):
    from yams_tpu_torch import native

    assert native.ingest_library() is not None       # g++ and <zstd.h> are here
    results = bench_ingest.main(["1"])
    assert len(results) == 4 * 3 * 3 and min(results.values()) > 0
    out = capsys.readouterr().out
    assert out.startswith("corpus: 1 MB synthetic text") and "per-core model: hot tier" in out
    assert bench_ingest.make_corpus(1) == _reference_script("bench_ingest").make_corpus(1)


def test_bench_ingest_exits_without_the_ingest_library():
    env = dict(os.environ, YAMS_TPU_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-m", "yams_tpu_torch.scripts.bench_ingest", "1"],
                       env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 1 and r.stdout == "" and "did not build" in r.stderr


def test_bench_ingest_device_runs_every_stage(capsys):
    rows = bench_ingest_device.main(["0.25", "--device", "cpu"])
    assert [r["stage"] for r in rows] == [
        "gear_hash_reference", "gear_hash", "sha256_rows", "device_chunk+hash_combined",
        "h2d_feed", "device_chunk_hash_e2e_0.25mb"]
    assert all(r["card"] == "cpu" and r["gbps"] > 0 for r in rows)
    assert rows[2]["chunks"] == 64 and rows[3]["target_gbps"] == 1.0
    assert rows[5]["matches_host"] and rows[5]["chunks"] > 1
    for r in rows[:3]:
        assert r["bound_ms"] > 0 and r["ms_per_iter"] > 0
    assert [json.loads(x) for x in capsys.readouterr().out.splitlines()] == rows


def test_bench_encode_matches_the_provider_and_the_reference(capsys):
    import torch

    from yams_tpu.core.config import EmbeddingConfig as RefEmbeddingConfig
    from yams_tpu.embed.simeon import SimeonEncoder
    from yams_tpu_torch.embed.provider import SimeonProvider

    res = bench_encode.main(["--docs", "64", "--reps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [line.split(" (")[0] for line in out.splitlines()] == [
        "host sketch", "device projection", "end-to-end encode",
        "reference NEON baselines: hash-only 237k docs/s; 384-d Achlioptas 9.1k docs/s; "
        "very_sparse 60.4k docs/s"]
    docs = bench_encode.make_docs(64, 256)
    assert docs == _reference_script("bench_encode").make_docs(64, 256)
    np.testing.assert_allclose(res["embeddings"],
                               SimeonProvider(device=torch.device("cpu")).encode(docs),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(res["embeddings"],
                               np.asarray(SimeonEncoder(RefEmbeddingConfig()).encode(docs)),
                               atol=1e-4, rtol=0)


def test_bench_pq_finds_the_planted_copies_on_both_routes(monkeypatch, capsys):
    """PQ_IMPL=pallas (K4's route: its twin on the CPU) and xla (the plain
    ADC scan) on 8,192 rows: the reference's JSON keys, recall@10 of the
    planted copies high and within 0.01 of each other."""
    got = {}
    for impl in ("pallas", "xla"):
        monkeypatch.setenv("PQ_IMPL", impl)
        got[impl] = bench_pq.main(["8192", "--device", "cpu"])
        assert set(got[impl]) == {"metric", "value", "unit", "impl", "recall10_planted",
                                  "self_recall1", "batch", "hbm_mb", "ms", "card"}
        assert got[impl]["metric"] == "pq4_qps_8192x768" and got[impl]["impl"] == impl
        assert got[impl]["recall10_planted"] >= 0.9 and got[impl]["self_recall1"] >= 0.9
    assert abs(got["pallas"]["recall10_planted"] - got["xla"]["recall10_planted"]) <= 0.01
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got["xla"]


def test_profile_legs_times_the_five_legs(monkeypatch, capsys):
    for var, val in (("BENCH_N", "4096"), ("BENCH_D", "64"), ("BENCH_B", "8"),
                     ("BENCH_ITERS", "2")):
        monkeypatch.setenv(var, val)
    out = profile_legs.main(["--device", "cpu"])
    assert list(out) == ["vec_matmul", "vec_approx_exact", "vec_exact_topk", "bm25", "full"]
    assert all(v > 0 for v in out.values())
    text = capsys.readouterr().out
    assert "approx_max_k has no PyTorch counterpart" in text and text.count("qps") == 5


@pytest.mark.parametrize("run", [
    lambda tmp: bench_ingest_device.main(["0.25"]),
    lambda tmp: bench_encode.main(["--docs", "8", "--reps", "1"]),
    lambda tmp: bench_pq.main(["8192"]),
    lambda tmp: profile_legs.main([]),
    lambda tmp: relevance_ab.run_queries(str(tmp / "data"), QUERIES, 5, "hybrid"),
    lambda tmp: profile_vec.main([]),
    lambda tmp: exp_coarse_bf16.main([]),
    lambda tmp: exp_recall_target.main([]),
    lambda tmp: profile_bm25.main([]),
    lambda tmp: profile_bm25b.main([]),
    lambda tmp: profile_lex_stages.main([]),
], ids=["bench_ingest_device", "bench_encode", "bench_pq", "profile_legs", "relevance_ab",
        "profile_vec", "exp_coarse_bf16", "exp_recall_target", "profile_bm25", "profile_bm25b",
        "profile_lex_stages"])
def test_scripts_default_to_the_card(run, monkeypatch, tmp_path):
    """No `--device`: each opens on CUDA, which raises where torch sees no
    card (no fallback to the host)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    monkeypatch.delenv("YAMS_TPU_SOCKET", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run(tmp_path)
