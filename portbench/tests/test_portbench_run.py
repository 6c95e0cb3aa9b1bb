"""The harness end to end on the CPU at a tiny size: a sound run comes out
correct, a run with the timed path broken underneath does not, and without
a card the command exits non-zero and prints no result."""

from __future__ import annotations

import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from portbench import control, run, spec
from portbench.tests.tiny import ENGINE, tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _measure(cell, seconds=0.3, trace=False, seed=5):
    return run.measure(tiny(cell), seed, seconds, trace, "cpu", time.monotonic(),
                       engine=ENGINE, log=lambda s: None)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert "No result" in p.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(cell):
    rec = _measure(cell)
    assert rec["correct"] and rec["failed"] == 0 and rec["requests"] > 0
    line = run.result_line(tiny(cell), rec, False, {"platform": "cpu", "kind": "cpu", "count": 1})
    names = {m["name"] for m in spec.cell(cell).end_to_end}
    assert set(line["metrics"]) == names
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(spec.cell(cell).limits)


def _half_batch(hq):
    """Half of the batch left out: the second half answered with the first's."""
    def f(sketch, term_ids, term_mask, *a, **kw):
        h = sketch.shape[0] // 2
        out = hq(sketch[:h], term_ids[:h], term_mask[:h], *a, **kw)
        return tuple(torch.cat([t, t]) for t in out)
    return f


def _altered(hq):
    """An answer altered where it is produced: query 0's docs moved by one."""
    def f(*a, **kw):
        vals, slots, bm_at, vec_at = hq(*a, **kw)
        slots = slots.clone()
        slots[0] = (slots[0] + 1) % kw["num_slots"]
        return vals, slots, bm_at, vec_at
    return f


def _stale(hq):
    """A request answered with the previous request's answers."""
    last = {}

    def f(*a, **kw):
        out = hq(*a, **kw)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return f


@pytest.mark.parametrize("fault", [_half_batch, _altered, _stale], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("cell", ["hybrid1m-bf16.bulk", "int8-10m.interactive"])
def test_a_broken_timed_path_makes_the_run_incorrect(cell, fault, monkeypatch):
    from yams_tpu_torch.search import fusion

    monkeypatch.setattr(fusion, "hybrid_query", fault(fusion.hybrid_query))
    rec = _measure(cell)
    assert rec["requests"] > 1 and rec["failed"] == 0
    assert not rec["correct"], rec["checks"]


def test_a_failing_request_is_counted_and_the_run_is_incorrect(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("planted")

    c = tiny(CELLS[0])
    sut = spec.system(c.config).Cell(c.config, c.mix, 1, "cpu", ENGINE)
    monkeypatch.setattr(spec, "system", lambda config: types.SimpleNamespace(
        Cell=lambda *a, **kw: sut))
    sut.warm = lambda n: None
    sut._hybrid_query = boom
    rec = run.measure(c, 1, 0.05, False, "cpu", time.monotonic(), engine=ENGINE,
                      log=lambda s: None)
    assert rec["failed"] == rec["attempted"] > 0 and not rec["correct"]


def test_a_traced_run_reduces_its_trace():
    cell = "int8-10m.bulk"
    rec = _measure(cell, trace=True)
    t = rec["trace"]
    assert t["window_s"] > 0 and len(t["idle_gaps"]) <= 10 and len(t["device_ops"]) <= 10
    # no device activity on the CPU: the device metrics read nothing
    assert t["busy_s"] is None
    for m in spec.cell(cell).per_layer:
        assert spec.reader(m["name"]).read(rec) is None
    assert rec["correct"]


def test_device_metrics_from_a_trace():
    rec = {"requests": 4, "bound_s_total": 0.01,
           "trace": {"busy_s": 0.5, "window_s": 2.0}}
    assert spec.reader("device_idle_pct.bulk").read(rec) == pytest.approx(75.0)
    assert spec.reader("hybrid_query_roofline.interactive").read(rec) == pytest.approx(2.0)


def test_host_clock_metrics():
    rec = {"queries": 3000, "window_s": 1.5, "setup_s": 7.0,
           "latencies_s": list(np.arange(1, 101) / 1000.0)}
    assert spec.reader("search_qps").read(rec) == pytest.approx(2000.0)
    assert spec.reader("search_p95_ms").read(rec) == pytest.approx(95.0)
    assert spec.reader("setup_s").read(rec) == 7.0


def test_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping", "yams_tpu_torch.search", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"jaxtyping", "yams_tpu_torch.search", "flaxen"} & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "yams_tpu.ops", types.ModuleType("yams_tpu.ops"))
    assert "yams_tpu.ops" in run.forbidden_modules()


def test_hand_kernel_launch_counters_are_read():
    import yams_tpu_torch.ops.scan  # noqa: F401

    counts = run.hand_kernel_launches()
    assert counts["yams_tpu_torch.ops.scan.exact_topk_cuda"] >= 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_own_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = spec.cell(cell)
    r = control.readings(c, 424242, True, torch.device("cuda", 0))
    assert all(r["program"][n] <= lim["limit"] for n, lim in c.limits.items()), r["program"]
    assert any(r["control"][n] > lim["limit"] for n, lim in c.limits.items()), r["control"]


class _Event:
    def __init__(self, a, b, name, on_device):
        self.a, self.b, self.n, self.dev = a, b, name, on_device

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def name(self):
        return self.n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.dev else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False


def test_a_device_trace_reduces_to_busy_time_ops_and_idle_gaps():
    from portbench import trace

    ms = 1_000_000
    events = [_Event(0, 4 * ms, "gemm", True), _Event(3 * ms, 5 * ms, "topk", True),
              _Event(8 * ms, 9 * ms, "gemm", True),
              _Event(5 * ms, 6 * ms, "cudaStreamSynchronize", False)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    t = trace.summarize(prof, window_s=0.010)
    assert t["busy_s"] == pytest.approx(0.006) and t["device_events"] == 3
    assert t["device_ops"] == [["gemm", pytest.approx(0.005)], ["topk", pytest.approx(0.002)]]
    # the gap 5-8 ms: its middle (6.5 ms) lies between CUDA calls; 1 ms of window edges
    assert dict(t["idle_gaps"]) == {trace.BETWEEN: pytest.approx(0.003),
                                    trace.EDGES: pytest.approx(0.001)}
    assert trace.idle_pct({"trace": t}) == pytest.approx(40.0)
