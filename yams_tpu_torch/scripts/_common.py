"""Timing and recall helpers shared by the experiments."""

from __future__ import annotations

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
