"""Spans of the query program, recorded in memory; off by default.

    from yams_tpu_torch import spans

    spans.enable()
    hybrid_query(...)
    spans.disable()
    records, clock = spans.drain()

`span(name, **attrs)` is a context manager. While the recorder is off it
returns one shared null context and records nothing: a global read and a
call. While it is on, each span appends a record

    (name, request, parent, start_ns, end_ns, attrs)

`parent` is the index (in the drained list) of the span that was open
around it in the same thread, -1 for a root; a root takes a new request id,
and the spans opened inside it share it. Nothing is written anywhere:
`drain()` hands the list over and empties it.

`begin(name, **attrs)` starts a span that is timed whether the recorder is
on or not (`end()` returns its milliseconds), for host work that reports
its own time (`SearchEngine.last_trace`). A span's end also ends the spans
opened inside it and left open, so an exception leaves none open.

The clock: spans are stamped with `time.perf_counter_ns()`. Each switch on
and off also records the pair (`perf_counter_ns()`, `time_ns()`);
`wall_offset_ns` turns the pairs into the offset that moves spans onto the
clock of `time.time_ns()`, which torch's profiler stamps its events with.

This module imports nothing of the package, so that every layer may use it.
"""

from __future__ import annotations

import itertools
import threading
import time

_perf = time.perf_counter_ns

MAX_CLOCK_DRIFT_NS = 1_000_000   # the pairs of one recording agree within 1 ms

_on = False
_records: list[list] = []        # [name, request, parent record, start, end, attrs, timed]
_clock: list[tuple[int, int]] = []
_requests = itertools.count()
_local = threading.local()       # each thread's stack of open records


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


def _open(name: str, attrs: dict, timed: bool) -> list:
    """Record a span beginning now, inside the thread's innermost open one."""
    try:
        stack = _local.stack
    except AttributeError:
        stack = _local.stack = []
    parent = stack[-1] if stack else None
    rec = [name, parent[1] if parent is not None else next(_requests), parent, _perf(),
           None, attrs, timed]
    _records.append(rec)
    stack.append(rec)
    return rec


class _Close:
    """Ends the innermost span `span()` opened, and any timed span (`begin`)
    left open inside it. One shared instance: a recorded span allocates
    nothing but its record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        end = _perf()
        stack = _local.stack
        rec = stack.pop()
        while rec[6]:
            rec[4] = end
            rec = stack.pop()
        rec[4] = end
        return False


_CLOSE = _Close()


def span(name: str, **attrs):
    """A span around a `with` block, recorded only while the recorder is on."""
    if not _on:
        return NULL
    _open(name, attrs, False)
    return _CLOSE


class Span:
    """A timed span (`begin`); recorded if the recorder was on when it began."""

    __slots__ = ("start_ns", "end_ns", "_rec")

    def __init__(self, name: str, attrs: dict):
        self.end_ns = None
        self._rec = _open(name, attrs, True) if _on else None
        self.start_ns = self._rec[3] if self._rec is not None else _perf()

    def __enter__(self) -> Span:
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def end(self) -> float:
        """Stamp the end (once; later calls return the same) and return the
        span's milliseconds. Spans opened inside it and still open end with
        it; one that a span around it ended keeps that end."""
        if self.end_ns is None:
            rec = self._rec
            if rec is not None and rec[4] is not None:
                self.end_ns = rec[4]
            else:
                self.end_ns = _perf()
                if rec is not None:
                    stack = _local.stack
                    at = next((i for i, r in enumerate(stack) if r is rec), len(stack))
                    for r in stack[at:]:
                        r[4] = self.end_ns
                    del stack[at:]
        return (self.end_ns - self.start_ns) * 1e-6


def begin(name: str, **attrs) -> Span:
    """A span timed whether the recorder is on or not; end it with `end()`
    or use it as a context manager."""
    return Span(name, attrs)


def enable() -> None:
    global _on
    _clock.append((_perf(), time.time_ns()))
    _on = True


def disable() -> None:
    global _on
    _on = False
    _clock.append((_perf(), time.time_ns()))


def drain() -> tuple[list[tuple], list[tuple[int, int]]]:
    """The records since the last drain, each (name, request, parent index,
    start_ns, end_ns, attrs) in the order the spans began, and the clock
    pairs of the switches since then; both are emptied. A span still open
    has end_ns None."""
    global _records, _clock
    recs, _records = _records, []
    clock, _clock = _clock, []
    index = {id(r): i for i, r in enumerate(recs)}
    out = [(r[0], r[1], index.get(id(r[2]), -1), r[3], r[4], r[5]) for r in recs]
    return out, clock


def wall_offset_ns(clock: list[tuple[int, int]]) -> int:
    """time_ns() less perf_counter_ns() over the clock pairs of one
    recording: add it to a span's stamps to read them on time_ns()'s clock.
    Raises ValueError without pairs, or where the pairs' offsets differ by
    more than MAX_CLOCK_DRIFT_NS (the wall clock stepped)."""
    if not clock:
        raise ValueError("no clock pairs: the recorder was never switched")
    offsets = [wall - perf for perf, wall in clock]
    drift = max(offsets) - min(offsets)
    if drift > MAX_CLOCK_DRIFT_NS:
        raise ValueError(f"the clock pairs' offsets differ by {drift} ns "
                         f"(more than {MAX_CLOCK_DRIFT_NS}): the wall clock stepped")
    return sum(offsets) // len(offsets)
