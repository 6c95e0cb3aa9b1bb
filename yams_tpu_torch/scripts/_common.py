"""Timing, recall, card and daemon helpers shared by the scripts."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops.scan import dot_f32


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


def sm_clock_mhz(fn, seconds: float = 2.0) -> float:
    """Median SM clock in MHz that `nvidia-smi --query-gpu=clocks.sm` reads
    every 100 ms while fn() runs back to back on the card for `seconds`."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    mhz = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
    if not mhz:
        raise RuntimeError("nvidia-smi read no SM clock")
    return float(np.median(mhz))


def zipf_text(n_bytes: int, seed: int) -> bytes:
    """bench.py's ingest payload generator, scaled: zipf(1.3) over 4,096 words."""
    rng = np.random.default_rng(seed)
    words = [f"word{i}" for i in range(4096)]
    zipf = rng.zipf(1.3, size=n_bytes // 6 + 1)   # every word + space >= 6 B
    data = " ".join(np.asarray(words, dtype=object)[zipf % 4096].tolist()).encode()
    if len(data) < n_bytes:
        raise RuntimeError("zipf text generator came up short")
    return data[:n_bytes]


def batch_ms(fn, iters: int, device: torch.device, best_of: int = 1):
    """Mean milliseconds a batch of fn(0), ..., fn(iters - 1), after a
    warm-up fn(0): CUDA events around the batches on a card, the host clock
    after a sync on the CPU; the least of `best_of` timed passes. -> (ms,
    the outputs of the last pass, left on the device)."""
    fn(0)
    sync(device)
    best, outs = float("inf"), []
    for _ in range(best_of):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = [fn(i) for i in range(iters)]
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end)
        else:
            t = time.perf_counter()
            outs = [fn(i) for i in range(iters)]
            ms = (time.perf_counter() - t) * 1e3
        best = min(best, ms / iters)
    return best, outs


def dot_bf16(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a @ b_t.T with bf16 operands and bf16 scores (the reference's
    preferred_element_type=bf16), for the design experiments. On CUDA a
    bf16 cuBLAS product: cuBLAS rounds its sums to bf16 once, but may also
    reduce in reduced precision where torch allows it
    (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction), so
    chip_smoke.py holds it to one bf16 ulp of dot_f32's sums rounded. On
    the CPU dot_f32's sums rounded once."""
    if a.device.type == "cuda":
        return torch.mm(a.to(torch.bfloat16), b_t.to(torch.bfloat16).t())
    return dot_f32(a, b_t).to(torch.bfloat16)


def batch_line(name: str, ms: float, batch: int, width: int = 12) -> str:
    """The reference scripts' row: `name  ms/batch  qps`."""
    return f"{name:{width}s} {ms:8.2f} ms/batch {batch * 1e3 / ms:10.0f} qps"


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
