"""The spans' reduction (portbench/spans.py) on a synthetic kineto trace, and
the counter metrics: busy and wait by layer, self time under nesting, the
harness's share, the sums against the trace's busy and idle time, and the
readers reading nothing where there is nothing to read."""

from __future__ import annotations

import time
import types

import pytest
import torch

from portbench import spans as ps
from portbench import spec
from portbench.tests.tiny import ENGINE, tiny

MS = 1_000_000


class _Event:
    def __init__(self, a, b, name, on_device, corr):
        self.a, self.b, self.n, self.dev, self.c = a, b, name, on_device, corr

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

    def correlation_id(self):
        return self.c


def _ms(x):
    return int(round(x * MS))


# (name, parent, start ms, end ms, attrs): one request
RECORDS = [("hybrid_query", -1, 0, 20, {}), ("embed", 0, 0.5, 2, {}),
           ("vector_leg", 0, 2, 10, {}), ("block", 2, 2, 8, {"lo": 0}),
           ("top_k", 3, 5, 8, {"rows": 4, "cols": 9, "k": 2}),
           ("lexical_leg", 0, 10, 14, {}),
           ("top_k", 5, 12, 14, {"rows": 4, "cols": 9, "k": 2}),
           ("tie_repair", 6, 13, 13.5, {"rows": 1}),
           ("fuse", 0, 14, 19, {})]
# (runtime call, its start ms, the device operation's start and end ms)
LAUNCHES = [("cudaLaunchKernel", 1.0, 1.2, 3.0),       # embed
            ("cudaLaunchKernel", 3.0, 3.0, 6.0),       # block
            ("cudaLaunchKernel", 5.5, 6.0, 7.0),       # top_k in the block
            ("cudaLaunchKernel", 11.0, 11.5, 12.0),    # lexical leg
            ("cudaLaunchKernel", 12.5, 13.0, 15.0),    # top_k in the lexical leg
            ("cudaLaunchKernel", 15.0, 14.5, 16.0),    # fuse, overlapping the last by 0.5
            ("cudaMemcpyAsync", 20.5, 21.0, 22.0)]     # the harness's answer copy
# the starts (ms) of the synchronizing runtime calls: two under top_k (the
# block's and the lexical leg's), one the harness's answer copy
SYNCS = [7.5, 13.8, 20.6]
WINDOW_S = 0.025


def _trace(offset_ns=0):
    events = []
    for c, (call, t, a, b) in enumerate(LAUNCHES, start=1):
        events.append(_Event(_ms(t), _ms(t + 0.1), call, False, c))
        events.append(_Event(_ms(a), _ms(b), f"kernel{c}", True, c))
    for c, t in enumerate(SYNCS, start=100):
        events.append(_Event(_ms(t), _ms(t + 0.1), "cudaStreamSynchronize", False, c))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    records = [(n, 7, p, _ms(a) - offset_ns, _ms(b) - offset_ns, attrs)
               for n, p, a, b, attrs in RECORDS]
    clock = [(1000, 1000 + offset_ns), (2000, 2000 + offset_ns)]
    return prof, records, clock


@pytest.mark.parametrize("offset_ns", [0, 5_000 * MS], ids=["same-clock", "moved"])
def test_busy_and_wait_by_layer_with_self_time_under_nesting(offset_ns):
    out = ps.reduce(*_trace(offset_ns), WINDOW_S)
    assert out["requests"] == 1
    lay = {n: (v["busy_ms"], v["wait_ms"], v["ops"]) for n, v in out["layers"].items()}
    # an op launched inside top_k is selection's, under block or the lexical leg
    assert lay["select"] == pytest.approx((3.0, 1.0, 2))
    assert lay["vector"] == pytest.approx((3.0, 4.5, 1))     # gap 7-11.5 under vector_leg
    assert lay["lexical"] == pytest.approx((0.5, 0.0, 1))
    assert lay["fusion"] == pytest.approx((2.8, 5.0, 2))     # the overlap counted once
    assert lay[ps.HARNESS] == pytest.approx((1.0, 0.0, 1))
    assert out["program_wait_ms"] == pytest.approx(10.5)
    assert out["wait_by_span"]["top_k"] == {"cudaLaunchKernel": pytest.approx(0.001)}
    assert out["wait_by_span"]["fuse"] == {"host between CUDA calls": pytest.approx(0.005)}
    sel = out["select_by_caller"]
    assert sel["vector"] == {"busy_s": pytest.approx(0.001), "calls": 1, "rows": 4,
                             "repair_rows": 0}
    assert sel["lexical"] == {"busy_s": pytest.approx(0.002), "calls": 1, "rows": 4,
                              "repair_rows": 1}
    assert out["launches"] == {"linked": 7, "unlinked": 0, "in_spans": 6,
                               "outside_copies": 1, "outside_other": 0}
    # the measured syncs, by the span the host was in
    assert out["syncs"] == {"top_k": 2.0, ps.HARNESS: 1.0} and out["program_syncs"] == 2.0


def test_the_layers_sum_to_the_traces_busy_and_idle_time():
    from portbench import trace

    prof, records, clock = _trace()
    out = ps.reduce(prof, records, clock, WINDOW_S)
    busy = sum(v["busy_s"] for v in out["layers"].values())
    wait = sum(v["wait_s"] for v in out["layers"].values())
    assert busy == pytest.approx(out["busy_s"]) == pytest.approx(0.0103)
    assert busy == pytest.approx(trace.summarize(prof, WINDOW_S)["busy_s"])
    assert wait + out["edges_s"] == pytest.approx(out["idle_s"]) == pytest.approx(0.0147)


def test_an_operation_whose_launch_is_missing_is_counted_apart():
    prof, records, clock = _trace()
    events = [e for e in prof.profiler.kineto_results.events() if e.c != 2 or e.dev]
    prof.profiler.kineto_results.events = lambda: events
    out = ps.reduce(prof, records, clock, WINDOW_S)
    assert out["layers"][ps.UNLINKED]["ops"] == 1
    assert out["launches"]["unlinked"] == 1
    assert sum(v["busy_s"] for v in out["layers"].values()) == pytest.approx(out["busy_s"])


def test_a_stepped_clock_is_refused():
    prof, records, _ = _trace()
    with pytest.raises(ValueError):
        ps.reduce(prof, records, [(0, 0), (10, 10 + 2 * MS)], WINDOW_S)


def test_the_counter_readers_read_nothing_without_device_activity_or_counters(monkeypatch):
    on_card = {"trace": {"busy_s": 1.0, "window_s": 2.0}}
    for base in ("host_syncs", "tie_repair_pct"):
        r = spec.reader(f"{base}.bulk")
        assert r.read({"trace": None}) is None
        assert r.read({"trace": {"busy_s": None, "window_s": 1.0}}) is None
    monkeypatch.setattr(ps, "counters", lambda: None)   # a program without them
    assert spec.reader("host_syncs.streamed").read(on_card) is None
    monkeypatch.setattr(ps, "counters", lambda: {"syncs": 86, "rows": 400,
                                                 "repair_rows": 3, "calls": 2})
    assert spec.reader("host_syncs.interactive").read(on_card) == 43.0
    assert spec.reader("tie_repair_pct.bulk").read(on_card) == pytest.approx(0.75)


def test_the_counters_count_blocks_plus_four_syncs_a_request():
    """The int8 cells: a top_k a block, the merge's, the lexical leg's and
    the fusion's, and the query's int8 quantization."""
    c = tiny("int8-10m.interactive")
    sut = spec.system(c.config).Cell(c.config, c.mix, 3, "cpu", ENGINE)
    before = ps.counters()
    for i in range(3):
        sut.request(i)
    got = ps.per_request(before, ps.counters())
    blocks = c.config["rows"] // ENGINE.streaming_block_rows
    assert got["host_syncs"] == blocks + 4
    assert got["counted"]["rows"] == 3 * c.mix["batch"] * (blocks + 3)


def test_a_traced_window_on_the_cpu_reduces():
    c = tiny("hybrid1m-bf16.bulk")
    sut = spec.system(c.config).Cell(c.config, c.mix, 3, "cpu", ENGINE)
    sut.warm(1)
    out = ps.traced_window(sut, 0.2, "cpu")
    # no device activity on the CPU: nothing busy, every request's spans there
    assert out["requests"] > 0 and out["busy_s"] is None and out["trace"]["busy_s"] is None
    blocks = c.config["rows"] // sut.kw.get("scan_block_rows", c.config["rows"] + 1)
    assert out["counters"]["host_syncs"] == blocks + 3
    assert out["launches"]["linked"] == 0


def test_the_cost_window_alternates_the_recorder():
    from yams_tpu_torch import spans

    c = tiny("int8-10m.bulk")
    sut = spec.system(c.config).Cell(c.config, c.mix, 3, "cpu", ENGINE)
    t = time.perf_counter()
    out = ps.cost_window(sut, 0.3)
    assert time.perf_counter() - t < 30
    assert out["requests"] >= 2 * sut.n_batches and out["off_ms"] > 0 and out["on_ms"] > 0
    blocks = c.config["rows"] // sut.kw["scan_block_rows"]
    # a request's spans: the root, embed, the vector leg, scores, mask_bias
    # and top_k in each block, the merge, the lexical leg and the fusion
    # with a top_k each, and a tie_repair for each repaired selection
    assert out["spans_per_request"] >= 4 + 4 * blocks + 2 + 2 * 2
    assert out["span_ns"] > 0 and out["direct_pct"] > 0
    assert {"off_span_ns", "off_direct_pct"} <= out.keys()
    assert spans.span("after") is spans.NULL and spans.drain() == ([], [])
