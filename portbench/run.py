"""Run one cell of the port's benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's workload entry) is
built on the card from the seed and warmed up; then one client sends its
requests in a closed loop, one in flight, for `--seconds`; then a sample of
the answers, drawn from the seed, is judged against the plain reference.
The last line of standard output is the result (JSON); the earlier lines
say what ran where; the last lines of standard error are the numbers
compared, each beside its limit. Without a card (or with fewer than the cell
asks for) it exits 2 and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "yams_tpu")   # top-level names, compared whole
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels", "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def pin_caches(root=spec.ROOT) -> None:
    """Every build and kernel cache at a fixed directory inside the checkout."""
    for var, sub in CACHES.items():
        os.environ[var] = str(root / ".portbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"


def card_identity() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi gave nothing ({exc.__class__.__name__})"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def hand_kernel_launches() -> dict[str, int]:
    """The port's hand-written kernels' launch counters (a `launches`
    attribute on each launcher), in the modules this process loaded."""
    counts = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith("yams_tpu_torch.") or mod is None:
            continue
        for attr, fn in list(vars(mod).items()):
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int):
                counts[f"{name}.{attr}"] = n
    return counts


def measure(cell: spec.CellSpec, seed: int, seconds: float, trace: bool, device,
            t_start: float, engine=None, log=print) -> dict:
    """Build, warm, run the window, judge: the run's record. `device` is
    taken as given (the card check is `main`'s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as tr

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    t_entry = time.monotonic()
    sut = spec.system(cell.config).Cell(cell.config, cell.mix, seed, device, engine)
    sync()
    t_built = time.monotonic()
    sut.warm(cell.mix["warm_requests"])
    sync()
    setup_s = time.monotonic() - t_start
    log(f"cell {cell.name}: {sut.describe()}; set-up {setup_s:.3f} s: imports and "
        f"CUDA init {t_entry - t_start:.3f}, context, index and queries "
        f"{t_built - t_entry:.3f}, "
        f"warm-up {t_start + setup_s - t_built:.3f}")

    # a traced run records the device's activity alone (see portbench/trace.py);
    # without a card (the CPU tests) the host's, which holds no device activity
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    prof = profile(activities=[activity]) if trace else contextlib.nullcontext()
    latencies, answers, failed = [], [], []
    with prof:
        w0 = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            try:
                out = sut.request(i)
            except Exception:                  # a request that fails is counted
                traceback.print_exc()
                out = None
                failed.append(i)
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            answers.append(out)
            i += 1
            if t1 - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
    n = len(answers)
    found = forbidden_modules()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = tr.summarize(prof, window_s) if trace else None
    done = [k for k in range(n) if answers[k] is not None]
    record = {
        "requests": n, "queries": len(done) * sut.batch, "attempted": n * sut.batch,
        "failed": len(failed) * sut.batch, "window_s": window_s,
        "latencies_s": [latencies[k] for k in done], "setup_s": setup_s,
        "trace": summary, "forbidden": found, "memory_peak_bytes": memory_peak,
        "bound_s_total": sum(sut.bound_s(k) for k in range(n)),
        "bound": sut.bound_of(0), "launches": hand_kernel_launches(),
    }
    # judge a sample of the answers, the program's state freed first
    t_ref = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    sample = sut.sample(done)
    numbers, compared = sut.judge(answers, sample, cell.tie_eps) if sample else ({}, 0)
    sync()
    record.update(compared_queries=compared, sample=sample,
                  reference_s=time.perf_counter() - t_ref)
    checks = {name: {"value": numbers.get(name), "limit": lim["limit"]}
              for name, lim in cell.limits.items()}
    record["checks"] = checks
    record["correct"] = (not failed and bool(sample) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()))
    return record


def result_line(cell: spec.CellSpec, record: dict, trace: bool, device_info: dict) -> dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=record["memory_peak_bytes"])
    line = {"correct": record["correct"], "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics, "device": device}
    if trace:
        t = record["trace"]
        device.update(busy_s=t["busy_s"] or 0.0, window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = record["checks"]
    return line


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    pin_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}. No result.", file=sys.stderr)
        return 2
    torch.set_num_threads(1)            # one client thread; no idle worker pool
    device = torch.device("cuda", 0)
    record = measure(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                     log=lambda s: print(s, flush=True))
    found = record["forbidden"] or forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}. "
              f"No result.", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(device)
    print(f"card: {card_identity()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"peak device memory: {record['memory_peak_bytes']} bytes")
    print(f"hand-kernel launches: {json.dumps(record['launches'])}")
    b = record["bound"]
    print(f"window: {record['requests']} requests, {record['queries']} queries in "
          f"{record['window_s']:.6f} s; least time a request {b['bound_s'] * 1e3:.6f} ms "
          f"by {b['bound_by']} ({b['bytes']:.6g} B, ops {b['ops']})")
    lat = sorted(record["latencies_s"])
    if lat:
        pick = [lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3 for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99)]
        print(f"latency ms ({len(lat)} requests): min {pick[0]:.3f}, p10 {pick[1]:.3f}, "
              f"median {pick[2]:.3f}, p90 {pick[3]:.3f}, p95 {pick[4]:.3f}, p99 {pick[5]:.3f}, "
              f"max {lat[-1] * 1e3:.3f}")
    if record["trace"]:
        t = record["trace"]
        print(f"trace: {t['device_events']} device operations, busy {t['busy_s']} s "
              f"of {t['window_s']} s")
    print(f"reference: {record['compared_queries']} queries of requests {record['sample']} "
          f"judged in {record['reference_s']:.3f} s")
    line = result_line(cell, record, bool(args.trace),
                       {"platform": "gpu", "kind": kind, "count": cell.chips})
    sys.stdout.flush()
    for name, c in record["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
