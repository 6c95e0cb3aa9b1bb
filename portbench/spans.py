"""The program's spans laid over a traced window: each layer's device time,
the layer the host was in during each idle gap, and the counters a request.

    python -m portbench.spans --workload <cell> --seed <n> --seconds <s> \
        [--cost-seconds <s>] [--out FILE]

builds and warms the cell as `portbench.run` does, then runs one window as a
traced run records it (device activity alone) with the program's span
recorder (`yams_tpu_torch.spans`) on, and reduces it (`reduce`). With
`--cost-seconds` it then runs an untraced window that switches the recorder
on and off pass by pass over the query pool, and gives each side's median
latency and a direct reading (spans a request times a span's cost): the
recorder's cost. It prints a line a layer and, last, the result as JSON
(also appended to FILE). Needs a card. It is a side harness: the
benchmark's own traced runs (`portbench.run`) switch no recorder on, so
its build, warm-up and window repeat `run.measure`'s until `measure` takes
the recorder switch and `reduce` itself.

The reduction. Each device operation is tied to the CUDA runtime call that
launched it (kineto's correlation id), and that call's start to the
innermost span open at that time, on the profiler's clock (the spans are
moved there by the recorder's clock pairs, `wall_offset_ns`). A span's name
gives its layer (LAYERS; a span not named there is a layer of its own);
where no span was open the work is the harness's (its loop and the four
answer copies a request).
  busy     the union of the device's operations, each instant given to the
           layer of the operation that covered it first: the layers' busy
           times sum to the trace's busy time;
  wait     the device's idle gaps, each given to the layer the host was in
           at its middle (the gaps `portbench/trace.py` labels by runtime
           call), also split by span and runtime call; with the window's
           edges they sum to the idle time;
  select_by_caller  the selection layer's busy time, rows and repaired
           rows split by the layer that called `top_k`;
  syncs    the runtime's synchronizing calls (`cudaStreamSynchronize` and
           the like) by the span they were made in, per request: the
           measured count the program's `syncs` counters are held to.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from portbench import run, spec
from portbench.trace import BETWEEN, _host_at, _union

LAYERS = {
    "hybrid_query": "fusion", "embed": "fusion", "fuse": "fusion",
    "vector_leg": "vector", "block": "vector", "scores": "vector",
    "mask_bias": "vector", "merge": "vector",
    "lexical_leg": "lexical",
    "top_k": "select", "tie_repair": "select",
}
HARNESS = "harness"       # outside every span: the loop and the answer copies
UNLINKED = "unlinked"     # a device operation whose runtime call is not in the trace


def layer_of(name: str) -> str:
    return LAYERS.get(name, name)


def _events(prof):
    """(device operations [(start, end, correlation)], runtime calls
    {correlation: (start, end, name)}, the starts of the synchronizing
    runtime calls) from a device-only kineto trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, calls, syncs = [], {}, []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                ops.append((a, b, e.correlation_id()))
            continue
        if e.correlation_id():
            calls[e.correlation_id()] = (a, b, e.name())
        if "Synchronize" in e.name():
            syncs.append(a)
    return ops, calls, sorted(syncs)


def reduce(prof, records: list, clock: list, window_s: float) -> dict:
    """The window's per-layer numbers from its trace (`prof`, a
    torch.profiler run over device activity), the recorder's drained
    `records` and `clock` pairs. Per request where the key ends in
    `_ms` or is `ops`; requests are the root `hybrid_query` spans."""
    from yams_tpu_torch.spans import wall_offset_ns

    off = wall_offset_ns(clock)
    done = [(i, r) for i, r in enumerate(records) if r[4] is not None]
    host = [(r[3] + off, r[4] + off, i) for i, r in done]
    requests = sum(1 for _, r in done if r[0] == "hybrid_query" and r[2] == -1)
    ops, calls, sync_starts = _events(prof)

    def caller(i):
        """The layer that called the selection span i."""
        while i >= 0 and layer_of(records[i][0]) == "select":
            i = records[i][2]
        return layer_of(records[i][0]) if i >= 0 else HARNESS

    # each operation: the span its launch was in
    launch = sorted((calls[c][0], k) for k, (_, _, c) in enumerate(ops) if c in calls)
    span_of = [None] * len(ops)
    for (_, k), label in zip(launch, _host_at(host, [t for t, _ in launch])):
        span_of[k] = label
    layers: dict[str, dict] = {}

    def acc(layer):
        return layers.setdefault(layer, {"busy_s": 0.0, "wait_s": 0.0, "ops": 0})

    by_caller: dict[str, dict] = {}

    def called_from(i):
        return by_caller.setdefault(caller(i), {"busy_s": 0.0, "calls": 0, "rows": 0,
                                                "repair_rows": 0})

    covered = 0             # the end of the busy time so far (stamps are positive)
    for k in sorted(range(len(ops)), key=lambda k: ops[k][0]):
        a, b, _ = ops[k]
        label = span_of[k]
        if label is None:
            layer = UNLINKED
        elif label == BETWEEN:
            layer = HARNESS
        else:
            layer = layer_of(records[label][0])
        new = max(0, b - max(a, covered))
        covered = max(covered, b)
        acc(layer)["busy_s"] += new * 1e-9
        acc(layer)["ops"] += 1
        if layer == "select":
            called_from(label)["busy_s"] += new * 1e-9
    for i, r in done:
        if r[0] == "top_k":
            called_from(i)["calls"] += 1
            called_from(i)["rows"] += r[5].get("rows", 0)
        elif r[0] == "tie_repair":
            called_from(i)["repair_rows"] += r[5].get("rows", 0)

    # the idle gaps: the layer (and span, and runtime call) at each middle
    busy = _union([(a, b) for a, b, _ in ops])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
    mids = [(a + b) // 2 for a, b in gaps]
    by_span: dict[str, dict[str, float]] = {}
    for (a, b), label, call in zip(gaps, _host_at(host, mids),
                                   _host_at(list(calls.values()), mids)):
        name = HARNESS if label == BETWEEN else records[label][0]
        acc(HARNESS if label == BETWEEN else layer_of(name))["wait_s"] += (b - a) * 1e-9
        row = by_span.setdefault(name, {})
        row[call] = row.get(call, 0.0) + (b - a) * 1e-9
    edges_s = window_s - (busy[-1][1] - busy[0][0]) * 1e-9 if busy else window_s

    # the synchronizing runtime calls, by the span the host was in
    syncs: dict[str, int] = {}
    for label in _host_at(host, sync_starts):
        name = HARNESS if label == BETWEEN else records[label][0]
        syncs[name] = syncs.get(name, 0) + 1

    # the clock's check: launches that fall outside every span are the
    # harness's answer copies
    inside = outside_copies = outside_other = 0
    for _, k in launch:
        if span_of[k] != BETWEEN:
            inside += 1
        elif "Memcpy" in calls[ops[k][2]][2]:
            outside_copies += 1
        else:
            outside_other += 1
    per = 1e3 / requests if requests else None
    return {
        "requests": requests, "window_s": window_s, "busy_s": busy_s if ops else None,
        "idle_s": window_s - busy_s, "edges_s": edges_s, "clock_offset_ns": off,
        "layers": {name: {"busy_ms": v["busy_s"] * per if per else None,
                          "wait_ms": v["wait_s"] * per if per else None,
                          "ops": v["ops"] / requests if requests else None,
                          "busy_s": v["busy_s"], "wait_s": v["wait_s"]}
                   for name, v in sorted(layers.items())},
        "program_wait_ms": (sum(v["wait_s"] for n, v in layers.items() if n != HARNESS)
                            * per if per else None),
        "wait_by_span": {n: dict(sorted(row.items(), key=lambda kv: -kv[1]))
                         for n, row in sorted(by_span.items(),
                                              key=lambda kv: -sum(kv[1].values()))},
        "select_by_caller": by_caller,
        "syncs": {n: c / requests if requests else None for n, c in sorted(syncs.items())},
        "program_syncs": (sum(c for n, c in syncs.items() if n != HARNESS) / requests
                          if requests else None),
        "launches": {"linked": len(launch), "unlinked": len(ops) - len(launch),
                     "in_spans": inside, "outside_copies": outside_copies,
                     "outside_other": outside_other},
    }


def counters() -> dict[str, int] | None:
    """The counters of the program this process loaded, counted since it
    began: `syncs`, summed over every function of the program that has
    that counter (`ops.select.top_k`'s one a call); `top_k`'s `rows` and
    `repair_rows`; the requests the program took (`search.fusion`'s
    `hybrid_query_calls`). None where the program lacks them (one older
    than they are)."""
    mods = {n: m for n, m in list(sys.modules.items())
            if n.startswith("yams_tpu_torch.") and m is not None}
    top_k = getattr(mods.get("yams_tpu_torch.ops.select"), "top_k", None)
    found = {"rows": getattr(top_k, "rows", None),
             "repair_rows": getattr(top_k, "repair_rows", None),
             "calls": getattr(mods.get("yams_tpu_torch.search.fusion"),
                              "hybrid_query_calls", None)}
    if not all(isinstance(v, int) for v in found.values()):
        return None
    syncing = {id(fn): fn.syncs for mod in mods.values() for fn in list(vars(mod).values())
               if callable(fn) and isinstance(getattr(fn, "syncs", None), int)}
    return dict(found, syncs=sum(syncing.values()))


def per_request(before: dict, after: dict) -> dict:
    """host_syncs and tie_repair_pct over the requests between two readings
    of `counters()`."""
    d = {k: after[k] - before[k] for k in after}
    return {"host_syncs": d["syncs"] / d["calls"] if d["calls"] else None,
            "tie_repair_pct": 100.0 * d["repair_rows"] / d["rows"] if d["rows"] else None,
            "counted": d}


def read_counters(run: dict) -> dict | None:
    """The metrics of the counters over every request of the process, for
    a run on the card: None where the trace holds no device activity (on
    the CPU nothing waits for a device) or the program has no counters."""
    tr = run.get("trace")
    c = counters()
    if not tr or tr["busy_s"] is None or c is None:
        return None
    return per_request(dict.fromkeys(c, 0), c)


def traced_window(sut, seconds: float, device) -> dict:
    """One window as a traced run records it, the recorder on inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as tr
    from yams_tpu_torch import spans

    on_card = torch.device(device).type == "cuda"
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    c0 = counters()
    with profile(activities=[activity]) as prof:
        spans.enable()
        w0 = time.perf_counter()
        i = 0
        while time.perf_counter() - w0 < seconds:
            sut.request(i)
            i += 1
        window_s = time.perf_counter() - w0
        spans.disable()
    records, clock = spans.drain()
    out = reduce(prof, records, clock, window_s)
    out["trace"] = tr.summarize(prof, window_s)
    out["counters"] = per_request(c0, counters())
    return out


def cost_window(sut, seconds: float) -> dict:
    """Untraced: the recorder on for every other pass over the query pool
    (the first off), so that each side serves the same batches, for
    `seconds` and at least a pass each; each side's median latency. Where
    the host spreads more than the recorder costs, the direct reading is
    the one to trust: the spans a request records times what one costs."""
    from yams_tpu_torch import spans

    lat = {False: [], True: []}
    recorded = 0
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < seconds or i < 2 * sut.n_batches:
        on = (i // sut.n_batches) % 2 == 1
        if on:
            spans.enable()
        t0 = time.perf_counter()
        sut.request(i)
        t1 = time.perf_counter()
        if on:
            spans.disable()
            recorded += len(spans.drain()[0])
        lat[on].append(t1 - t0)
        i += 1
    off_ms, on_ms = (statistics.median(lat[s]) * 1e3 for s in (False, True))
    per_request = recorded / len(lat[True])
    cost = span_cost_ns()
    return {"requests": i, "off_ms": off_ms, "on_ms": on_ms,
            "cost_pct": 100.0 * (on_ms - off_ms) / off_ms,
            "spans_per_request": per_request, "span_ns": cost["on_ns"],
            "off_span_ns": cost["off_ns"],
            "direct_pct": 100.0 * per_request * cost["on_ns"] * 1e-6 / off_ms,
            "off_direct_pct": 100.0 * per_request * cost["off_ns"] * 1e-6 / off_ms}


def span_cost_ns(n: int = 200, repeats: int = 500) -> dict[str, float]:
    """The host time a span adds, a span, medians of `repeats` loops of `n`
    (about a request's). `off_ns`, what every untraced request pays: a loop
    of spans with the recorder off, each around two counter adds, against
    the same loop of plain statements, as the program was before its
    spans; an upper bound, as `top_k` is the only span with counters and
    the most attributes. `on_ns`: the loop on, drained after each as the
    cost window drains, against the loop off."""
    from yams_tpu_torch import spans

    def bare() -> int:
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        return time.perf_counter_ns() - t

    def loop() -> int:
        t = time.perf_counter_ns()
        for _ in range(n):
            with spans.span("top_k", rows=64, cols=262144, k=64):
                loop.syncs += 1
                loop.rows += 64
        return time.perf_counter_ns() - t

    loop.syncs = loop.rows = 0
    none = statistics.median(bare() for _ in range(repeats))
    off = statistics.median(loop() for _ in range(repeats))
    on = []
    for _ in range(repeats):
        spans.enable()
        on.append(loop())
        spans.disable()
        spans.drain()
    return {"off_ns": (off - none) / n, "on_ns": (statistics.median(on) - off) / n}


def describe(out: dict) -> list[str]:
    lines = []
    for name, v in out["layers"].items():
        lines.append(f"layer {name}: busy {v['busy_ms']:.4f} ms, wait {v['wait_ms']:.4f} ms, "
                     f"{v['ops']:.1f} device operations a request")
    lines.append(f"program wait {out['program_wait_ms']:.4f} ms a request; launches "
                 f"{json.dumps(out['launches'])}")
    lines.append(f"synchronizing runtime calls a request: {json.dumps(out['syncs'])}; "
                 f"the counters' host_syncs {out.get('counters', {}).get('host_syncs')}")
    for name, row in list(out["wait_by_span"].items())[:8]:
        lines.append(f"wait under {name}: " + ", ".join(f"{c} {s:.4f} s" for c, s in
                                                       list(row.items())[:4]))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost-seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    run.pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("portbench.spans needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    sut = spec.system(cell.config).Cell(cell.config, cell.mix, args.seed, device)
    sut.warm(cell.mix["warm_requests"])
    torch.cuda.synchronize(device)
    out = {"workload": cell.name, "seed": args.seed, "card": run.card_identity(),
           "torch": torch.__version__}
    out["traced"] = traced_window(sut, args.seconds, device)
    if args.cost_seconds > 0:
        out["cost"] = cost_window(sut, args.cost_seconds)
    for line in describe(out["traced"]):
        print(line, flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
