"""End-to-end daemon serving benchmark: client-saturation sweep.

Port of scripts/bench_daemon.py. It measures what a production client sees
(socket round trip + host glue + device program), unlike a pure device
throughput. The daemon is the port's, a real subprocess
(`python -m yams_tpu_torch.daemon --device ...`, its own interpreter and
GIL, like production), on the card unless `--device cpu` is given; each
client level runs client threads (or, with BD_MODE=pipelined, up to 4
connections of the port's PipelinedDaemonClient keeping `clients` requests
in flight).

    python -m yams_tpu_torch.scripts.bench_daemon [n_docs] [n_requests]
        [clients_csv] [filtered_frac] [--device cuda|cpu]
    e.g. ... 5000 200 1,2,4,8,16,32,64,128 0.25

Environment: BD_MODE (pipelined), BD_MAX_BATCH (64; also the daemon's
YAMS_SEARCH_BATCH_PAD), BD_WINDOW_MS (2.0), BD_INFLIGHT (4), BD_WORKERS (4),
BD_PROFILE (a path: the daemon runs under cProfile). The reference's
YAMS_TPU_JIT_CACHE (a JAX compile cache) has no counterpart: the port
compiles no program.

Prints one JSON line after seeding ({"event": "seeded", "docs", "ingest_s"})
and one per client level:
  {"clients": N, "qps": ..., "p50_ms": ..., "p95_ms": ..., "errors": ...,
   "batching": {...}}   (pipelined adds "mode" and "conns")
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import pathlib
import subprocess
import tempfile
import time

import numpy as np

from ._common import start_daemon

WORDS = (
    "kernel scheduler thread mutex gradient tensor batch layer tomato basil "
    "pasta olive recipe salad driver interrupt vector index search daemon "
    "socket frame protocol chunk store manifest graph node edge token cache"
).split()

BENCH_TOML = """
[chunking]
min_size = 1024
avg_size = 4096
max_size = 16384

[vector]
capacity = {capacity}
block_rows = 1024

[daemon]
search_batch_window_ms = {window_ms}
search_batch_max = {max_batch}
search_batch_inflight = {inflight}
search_workers = {workers}
"""


def _pipelined_worker(sock_path: str, queries: list[str], n_requests: int,
                      inflight: int, filtered_frac: float,
                      ) -> tuple[list[float], int]:
    """One connection, `inflight` outstanding requests (closed-loop per
    slot): measures server capacity without needing `inflight` OS threads."""
    from ..daemon.aclient import PipelinedDaemonClient

    c = PipelinedDaemonClient(sock_path, max_inflight=inflight + 8)
    lat: list[float] = []
    errs = 0
    done = 0
    outstanding: list[tuple[float, object]] = []
    try:
        j = 0
        while done < n_requests:
            while len(outstanding) < inflight and j < n_requests:
                q = queries[j % len(queries)]
                kw = {}
                if filtered_frac > 0 and (j % 100) < filtered_frac * 100:
                    kw["path_glob"] = "*.txt"
                outstanding.append(
                    (time.perf_counter(), c.search(q, limit=10, **kw)))
                j += 1
            t0, fut = outstanding.pop(0)
            try:
                r = fut.result(timeout=600)
                assert "hits" in r
            except Exception:
                errs += 1
            lat.append(time.perf_counter() - t0)
            done += 1
    finally:
        c.close()
    return lat, errs


def _client_worker(sock_path: str, queries: list[str], n_requests: int,
                   wid: int, filtered_frac: float) -> tuple[list[float], int]:
    from ..daemon.client import DaemonClient

    c = DaemonClient(sock_path)
    lat: list[float] = []
    errs = 0
    try:
        for j in range(n_requests):
            q = queries[(wid * 31 + j) % len(queries)]
            kw = {}
            if filtered_frac > 0 and (j % 100) < filtered_frac * 100:
                kw["path_glob"] = "*.txt"  # matches all bench docs
            t0 = time.perf_counter()
            try:
                r = c.search(q, limit=10, **kw)
                assert "hits" in r
            except Exception:
                errs += 1
            lat.append(time.perf_counter() - t0)
    finally:
        c.close()
    return lat, errs


def run_level(sock_path: str, queries: list[str], n_clients: int,
              n_requests: int, filtered_frac: float) -> dict:
    pipelined = os.environ.get("BD_MODE", "") == "pipelined"
    t0 = time.perf_counter()
    if pipelined:
        # n_clients = total in-flight, spread over up to 4 connections
        n_conns = min(4, max(1, n_clients // 16)) if n_clients > 1 else 1
        per_conn = max(1, n_clients // n_conns)
        per_reqs = (n_requests * n_clients) // n_conns
        with cf.ThreadPoolExecutor(n_conns) as pool:
            futs = [pool.submit(_pipelined_worker, sock_path, queries,
                                per_reqs, per_conn, filtered_frac)
                    for _ in range(n_conns)]
            lats, errs = [], 0
            for f in futs:
                ls, e = f.result()
                lats.extend(ls)
                errs += e
        dt = time.perf_counter() - t0
        total = per_reqs * n_conns
        return {
            "clients": n_clients, "mode": "pipelined", "conns": n_conns,
            "qps": round(total / dt, 1),
            "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 1),
            "p95_ms": round(float(np.percentile(lats, 95)) * 1e3, 1),
            "errors": errs,
        }
    with cf.ThreadPoolExecutor(n_clients) as pool:
        futs = [pool.submit(_client_worker, sock_path, queries, n_requests,
                            w, filtered_frac) for w in range(n_clients)]
        lats: list[float] = []
        errs = 0
        for f in futs:
            ls, e = f.result()
            lats.extend(ls)
            errs += e
    dt = time.perf_counter() - t0
    total = n_clients * n_requests
    return {
        "clients": n_clients,
        "qps": round(total / dt, 1),
        "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 1),
        "p95_ms": round(float(np.percentile(lats, 95)) * 1e3, 1),
        "errors": errs,
    }


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_docs", nargs="?", type=int, default=5000)
    ap.add_argument("n_requests", nargs="?", type=int, default=200)
    ap.add_argument("levels", nargs="?", default="1,2,4,8,16,32,64,128")
    ap.add_argument("filtered_frac", nargs="?", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_docs, n_requests = args.n_docs, args.n_requests
    levels = [int(x) for x in args.levels.split(",")]
    filtered_frac = args.filtered_frac
    out: list[dict] = []

    with tempfile.TemporaryDirectory() as td:
        tdp = pathlib.Path(td)
        data_dir = tdp / "data"
        sock = tdp / "bench.sock"
        # config.toml via XDG so the daemon subprocess picks it up
        cfg_dir = tdp / "xdg" / "yams_tpu"
        cfg_dir.mkdir(parents=True)
        max_batch = int(os.environ.get("BD_MAX_BATCH", "64"))
        (cfg_dir / "config.toml").write_text(BENCH_TOML.format(
            capacity=max(2 * n_docs, 2048),
            window_ms=float(os.environ.get("BD_WINDOW_MS", "2.0")),
            max_batch=max_batch,
            inflight=int(os.environ.get("BD_INFLIGHT", "4")),
            workers=int(os.environ.get("BD_WORKERS", "4"))))
        env = {
            "YAMS_TPU_STORAGE": str(data_dir),
            "YAMS_TPU_SOCKET": str(sock),
            "XDG_CONFIG_HOME": str(tdp / "xdg"),
            # every batch pads to max_batch, as the reference's one program shape
            "YAMS_SEARCH_BATCH_PAD": str(max_batch),
        }
        prof = os.environ.get("BD_PROFILE")
        prefix = ("-m", "cProfile", "-o", prof) if prof else ()
        log = open(tdp / "daemon.log", "wb")
        daemon = start_daemon(env, args.device, log, sock, prefix)
        try:
            from ..daemon.aclient import PipelinedDaemonClient
            from ..daemon.client import DaemonClient

            rng = np.random.default_rng(0)
            # seed corpus via the bulk directory path (one add_path request)
            corpus = tdp / "corpus"
            corpus.mkdir()
            for i in range(n_docs):
                text = " ".join(rng.choice(WORDS, size=24))
                (corpus / f"d{i}.txt").write_text(text)
            seed = DaemonClient(sock)
            t_ing = time.perf_counter()
            rep = seed.add_path(str(corpus), recursive=True)
            ing_dt = time.perf_counter() - t_ing
            queries = [" ".join(rng.choice(WORDS, size=3)) for _ in range(64)]
            seed.call("search", timeout=1800.0, query=queries[0])
            seed.call("search", timeout=1800.0, query=queries[1], path_glob="*.txt")
            # mixed-batch warmup: filtered and unfiltered requests in one batch
            warm = PipelinedDaemonClient(str(sock), max_inflight=64)
            futs = [warm.search(queries[j % len(queries)],
                                **({"path_glob": "*.txt"} if j % 4 == 0 else {}))
                    for j in range(48)]
            for f in futs:
                f.result(timeout=600)
            warm.close()
            seeded = {"event": "seeded", "docs": rep.get("files_indexed", n_docs),
                      "ingest_s": round(ing_dt, 1)}
            out.append(seeded)
            print(json.dumps(seeded), flush=True)

            for n_clients in levels:
                r = run_level(str(sock), queries, n_clients, n_requests, filtered_frac)
                st = seed.status(detailed=True)
                r["batching"] = st.get("search_batching", {})
                r["batching"].pop("latency_hist", None)
                out.append(r)
                print(json.dumps(r), flush=True)
            seed.shutdown()
            seed.close()
        finally:
            try:
                daemon.wait(timeout=60)
            except subprocess.TimeoutExpired:
                daemon.kill()
            log.close()
    return out


if __name__ == "__main__":
    main()
