"""Background integrity verification + repair hooks.

Parity: src/integrity/ (IntegrityVerifier scans blocks against their content
hash; RepairManager re-stores from alternate sources when available).

Copied from yams_tpu/storage/integrity.py (the port imports
nothing of yams_tpu).
"""

from __future__ import annotations

import dataclasses
import time

from ..ingest.hasher import sha256_bytes


@dataclasses.dataclass(slots=True)
class VerifyReport:
    scanned: int = 0
    ok: int = 0
    corrupted: list[str] = dataclasses.field(default_factory=list)
    missing: list[str] = dataclasses.field(default_factory=list)
    duration_ms: float = 0.0


class IntegrityVerifier:
    def __init__(self, engine, refcounter):
        self.engine = engine
        self.refcounter = refcounter

    def verify_block(self, h: str) -> str:
        """Return 'ok' | 'corrupted' | 'missing'."""
        if not self.engine.exists(h):
            return "missing"
        try:
            data = self.engine.retrieve(h)
        except Exception:
            return "corrupted"
        return "ok" if sha256_bytes(data) == h else "corrupted"

    def verify_all(self, limit: int | None = None) -> VerifyReport:
        """Scan every referenced block."""
        t0 = time.monotonic()
        report = VerifyReport()
        for h in sorted(self.refcounter.known_blocks()):
            if limit is not None and report.scanned >= limit:
                break
            report.scanned += 1
            state = self.verify_block(h)
            if state == "ok":
                report.ok += 1
            elif state == "missing":
                report.missing.append(h)
            else:
                report.corrupted.append(h)
        report.duration_ms = (time.monotonic() - t0) * 1e3
        return report

    def quarantine_corrupted(self, report: VerifyReport) -> int:
        """Remove corrupted blocks so re-ingest can repair them."""
        n = 0
        for h in report.corrupted:
            if self.engine.remove(h):
                n += 1
        return n
