"""Progress reporting for store/retrieve operations.

Parity: include/yams/api/progress_reporter.h (Progress struct +
ProgressReporter with rate/ETA/cancellation/sub-reporters) and the
ProgressCallback parameters on IContentStore::store/retrieve
(include/yams/api/content_store.h:88-115). The callback receives a Progress
snapshot at phase transitions and per processed chunk; cancel() makes the
next report raise OperationCancelled, which aborts the store mid-flight —
blocks already written are unreferenced (no manifest committed) and are
reclaimed by the orphan GC scan, identical to the crash model.

Copied from yams_tpu/storage/progress.py (the port imports
nothing of yams_tpu).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable


class OperationCancelled(RuntimeError):
    """Raised inside store/retrieve when the reporter was cancelled."""


@dataclasses.dataclass(slots=True)
class Progress:
    bytes_processed: int = 0
    total_bytes: int = 0
    percentage: float = 0.0
    estimated_remaining_s: float = 0.0
    elapsed_s: float = 0.0
    bytes_per_second: float = 0.0
    current_operation: str = ""
    is_cancelled: bool = False


ProgressCallback = Callable[[Progress], None]


class ProgressReporter:
    def __init__(self, total_bytes: int = 0,
                 callback: ProgressCallback | None = None):
        self._lock = threading.Lock()
        self._total = int(total_bytes)
        self._processed = 0
        self._op = ""
        self._cancelled = False
        self._t0 = time.monotonic()
        self._callback = callback

    def set_callback(self, callback: ProgressCallback | None) -> None:
        with self._lock:
            self._callback = callback

    def set_total_bytes(self, total: int) -> None:
        with self._lock:
            self._total = int(total)

    # -- reporting ---------------------------------------------------------
    def report(self, processed: int, operation: str | None = None) -> None:
        with self._lock:
            self._processed = int(processed)
            if operation is not None:
                self._op = operation
            cb = self._callback
            snap = self._snapshot()
        if self._cancelled:
            raise OperationCancelled(self._op or "operation cancelled")
        if cb is not None:
            cb(snap)

    def add(self, delta: int, operation: str | None = None) -> None:
        self.report(self._processed + int(delta), operation)

    # -- queries -----------------------------------------------------------
    def _snapshot(self) -> Progress:
        elapsed = time.monotonic() - self._t0
        rate = self._processed / elapsed if elapsed > 0 else 0.0
        remaining = ((self._total - self._processed) / rate
                     if rate > 0 and self._total else 0.0)
        return Progress(
            bytes_processed=self._processed,
            total_bytes=self._total,
            percentage=(100.0 * self._processed / self._total
                        if self._total else 0.0),
            estimated_remaining_s=remaining,
            elapsed_s=elapsed,
            bytes_per_second=rate,
            current_operation=self._op,
            is_cancelled=self._cancelled,
        )

    def progress(self) -> Progress:
        with self._lock:
            return self._snapshot()

    @property
    def is_complete(self) -> bool:
        return self._total > 0 and self._processed >= self._total

    # -- cancellation ------------------------------------------------------
    def cancel(self) -> None:
        self._cancelled = True

    @property
    def is_cancelled(self) -> bool:
        return self._cancelled

    def throw_if_cancelled(self) -> None:
        if self._cancelled:
            raise OperationCancelled(self._op or "operation cancelled")

    # -- composition -------------------------------------------------------
    def sub_reporter(self, sub_total: int) -> "ProgressReporter":
        """A reporter for a portion of the work; its reports add into this
        one proportionally (reference: createSubReporter)."""
        parent = self
        base = self._processed

        class _Sub(ProgressReporter):
            def report(self, processed: int,
                       operation: str | None = None) -> None:
                super().report(processed, operation)
                parent.report(base + int(processed), operation)

        sub = _Sub(sub_total)
        sub._cancelled = self._cancelled
        return sub
