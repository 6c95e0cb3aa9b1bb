"""Timing, recall, card and daemon helpers shared by the scripts."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def qps_windows(run, iters: int, batch: int, windows: int, device: torch.device):
    """Queries per second of `run(i)` over `windows` windows of `iters`
    batches each, after one warm-up batch: (median, every window)."""
    run(0)
    sync(device)
    out = []
    for _ in range(windows):
        t = time.perf_counter()
        for i in range(iters):
            run(i)
        sync(device)
        out.append(iters * batch / (time.perf_counter() - t))
    return float(np.median(out)), out


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches, after a warm-up
    (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def recall(ids: np.ndarray, oracle: np.ndarray) -> float:
    """Mean |ids[j] & oracle[j]| / k over rows, both (rows, k)."""
    k = oracle.shape[1]
    return float(np.mean([len(np.intersect1d(a, o)) / k for a, o in zip(ids, oracle)]))


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def card_line(device: torch.device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the card (its first line), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[device.index or 0] if out else ""


REPO = pathlib.Path(__file__).resolve().parents[2]


def start_daemon(env: dict, device: str, log, sock: pathlib.Path,
                 prefix: tuple = ()) -> subprocess.Popen:
    """`python -m yams_tpu_torch.daemon --device <device>` in a subprocess
    (its own interpreter, as in production) with `env`, its output to
    `log`; returns once `sock` exists. `prefix` goes between the
    interpreter and `-m` (a profiler, say)."""
    proc = subprocess.Popen(
        [sys.executable, *prefix, "-m", "yams_tpu_torch.daemon", "--device", str(device)],
        stdout=log, stderr=log, stdin=subprocess.DEVNULL, env={**os.environ, **env},
        cwd=str(REPO))
    for _ in range(1200):
        if sock.exists():
            return proc
        if proc.poll() is not None:
            raise RuntimeError(f"the daemon exited with {proc.returncode} before its socket "
                               "appeared")
        time.sleep(0.1)
    proc.kill()
    raise RuntimeError("daemon socket never appeared")
