"""The traced window, reduced from `torch.profiler`'s events.

A traced run records the device's activity alone (CUPTI: the device's
operations and the host's CUDA runtime calls), started after the warm-up's
last sync and stopped after the window's last request, so every device
operation in the trace belongs to a request of the window. Recording the
host's operators too would add host time to every operator and so idle
time to the device. From the trace:
  busy_s      the union of the device's operations (kernels, copies, sets);
  window_s    the window's length, by the host's clock;
  device_ops  the ten device operations that took most time, summed by name;
  idle_gaps   the device's idle time in the window, summed by the CUDA
              runtime call the host was in at each gap's middle ("host
              between CUDA calls" where it was in none: Python and the
              operators' dispatch), the ten largest; the idle time before
              the first and after the last operation is its own entry.
Where the trace holds no device activity, busy_s is None, and the readers
that need it read nothing.
"""

from __future__ import annotations

import torch

BETWEEN = "host between CUDA calls"
EDGES = "window edges (before the first and after the last device operation)"


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(prof, window_s: float) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((a, b, e.name()))
        else:
            host.append((a, b, e.name()))
    by_name: dict[str, int] = {}
    for a, b, n in device:
        by_name[n] = by_name.get(n, 0) + (b - a)
    busy = _union([(a, b) for a, b, _ in device])
    busy_ns = sum(b - a for a, b in busy)
    idle: dict[str, float] = {}
    if busy:
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
        for (a, b), label in zip(gaps, _host_at(host, [(a + b) // 2 for a, b in gaps])):
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
        edges = window_s - (busy[-1][1] - busy[0][0]) * 1e-9
        if edges > 0:
            idle[EDGES] = edges
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns * 1e-9 if device else None,
            "window_s": window_s,
            "device_events": len(device),
            "device_ops": [[n, ns * 1e-9] for n, ns in top],
            "idle_gaps": [[n, s] for n, s in top_idle]}


def _host_at(host: list, times: list[int]) -> list[str]:
    """For each of the ascending `times`, the innermost host range holding
    it (ranges nest: a sweep keeps the open ones on a stack)."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    labels, stack, k = [], [], 0
    for t in times:
        while k < len(host) and host[k][0] <= t:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        labels.append(stack[-1][2] if stack else BETWEEN)
    return labels


def idle_pct(run: dict) -> float | None:
    tr = run.get("trace")
    if not tr or tr["busy_s"] is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(run: dict) -> float | None:
    """The least device time of the traced requests over the device's busy
    time in the window (which holds those requests and nothing else)."""
    tr = run.get("trace")
    if not tr or tr["busy_s"] is None or not run["requests"]:
        return None
    return 100.0 * run["bound_s_total"] / tr["busy_s"]
