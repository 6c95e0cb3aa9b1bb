"""Measure the IPC protocol ceiling: ping QPS through the daemon socket.

Port of scripts/bench_ipc_ceiling.py. This bounds what ANY request type can
serve on this host: it exercises client encode -> unix socket -> daemon
asyncio read -> dispatch -> encode response -> client decode, with a no-op
handler. If search QPS at high client counts approaches this ceiling, the
serving bottleneck is protocol CPU, not the device path or batching design.

The daemon is the port's (`python -m yams_tpu_torch.daemon --device ...`)
in a subprocess over a temporary data dir; it opens on the card unless
`--device cpu` is given (the reference forces its daemon onto the CPU with
JAX_PLATFORMS; a ping never reaches the device either way). One JSON line
per client level: {"op", "clients", "qps", "p50_ms", "errors"}.

    python -m yams_tpu_torch.scripts.bench_ipc_ceiling [levels_csv] [n_requests]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import threading
import time

import numpy as np

from ._common import start_daemon


def run_level(sock_path: str, n_clients: int, n_requests: int,
              op: str = "ping") -> dict:
    from ..daemon.client import DaemonClient

    lats: list[float] = []
    lock = threading.Lock()
    errs = 0
    per = n_requests // n_clients

    def worker():
        nonlocal errs
        c = DaemonClient(sock_path)
        mine = []
        for _ in range(per):
            t0 = time.perf_counter()
            try:
                if op == "ping":
                    c.call("ping")
                else:
                    c.status()
            except Exception:
                errs += 1
            mine.append(time.perf_counter() - t0)
        c.close()
        with lock:
            lats.extend(mine)

    ts = [threading.Thread(target=worker) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    dt = time.perf_counter() - t0
    a = np.asarray(lats)
    return {
        "op": op, "clients": n_clients,
        "qps": round(len(a) / dt, 1),
        "p50_ms": round(float(np.percentile(a, 50)) * 1e3, 2),
        "errors": errs,
    }


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("levels", nargs="?", default="16,64,128")
    ap.add_argument("n_requests", nargs="?", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    levels = [int(x) for x in args.levels.split(",")]
    rows = []
    with tempfile.TemporaryDirectory() as td:
        tdp = pathlib.Path(td)
        sock = tdp / "ipc.sock"
        env = {"YAMS_TPU_STORAGE": str(tdp / "data"), "YAMS_TPU_SOCKET": str(sock)}
        with open(tdp / "daemon.log", "wb") as log:
            daemon = start_daemon(env, args.device, log, sock)
            try:
                from ..daemon.client import DaemonClient

                ctl = DaemonClient(sock)
                ctl.call("ping")
                for n in levels:
                    rows.append(run_level(str(sock), n, args.n_requests))
                    print(json.dumps(rows[-1]), flush=True)
                ctl.shutdown()
                ctl.close()
            finally:
                try:
                    daemon.wait(timeout=30)
                except Exception:
                    daemon.kill()
    return rows


if __name__ == "__main__":
    main()
