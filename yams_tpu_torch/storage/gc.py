"""Garbage collection of zero-reference blocks.

Parity: src/storage/garbage_collector.cpp.

Copied from yams_tpu/storage/gc.py (the port imports
nothing of yams_tpu).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(slots=True)
class GCStats:
    blocks_deleted: int = 0
    bytes_reclaimed: int = 0
    blocks_scanned: int = 0


class GarbageCollector:
    def __init__(self, engine, refcounter):
        self.engine = engine
        self.refcounter = refcounter

    def collect(self, limit: int = 100_000) -> GCStats:
        """Delete blocks whose refcount is zero."""
        stats = GCStats()
        victims = self.refcounter.unreferenced(limit=limit)
        deleted = []
        for h in victims:
            stats.blocks_scanned += 1
            try:
                size = self.engine.inner.size_of(h) if hasattr(self.engine, "inner") \
                    else self.engine.size_of(h)
            except Exception:
                size = 0
            if self.engine.remove(h):
                stats.blocks_deleted += 1
                stats.bytes_reclaimed += size
            deleted.append(h)
        self.refcounter.forget(deleted)
        return stats

    def orphan_scan(self) -> list[str]:
        """Blocks present on disk but unknown to the refcounter (repair aid)."""
        known = self.refcounter.known_blocks()
        return [h for h in self.engine.iter_blocks() if h not in known]
