"""Write-ahead log: CRC-framed msgpack records in rotating segments.

Parity: src/wal/ (include/yams/wal/wal_entry.h ops StoreBlock/DeleteBlock/
UpdateReference/UpdateMetadata; 100 MB segments; group commit; CRC'd entries;
replay recovery). We use smaller default segments and msgpack payloads but the
same framing discipline: [u32 len][u32 crc32][payload], truncated tails are
dropped at replay (torn-write tolerance).

Copied from yams_tpu/storage/wal.py (the port imports
nothing of yams_tpu).
"""

from __future__ import annotations

import os
import pathlib
import struct
import threading
import time
import zlib
from typing import Any, Callable, Iterator

import msgpack

_FRAME = struct.Struct("<II")

OP_STORE_BLOCK = "store_block"
OP_DELETE_BLOCK = "delete_block"
OP_UPDATE_REFERENCE = "update_ref"
OP_UPDATE_METADATA = "update_meta"
OP_CHECKPOINT = "checkpoint"


class WalManager:
    def __init__(
        self,
        wal_dir: str | pathlib.Path,
        segment_bytes: int = 16 * 1024 * 1024,
        sync_every: int = 64,
        sync_interval_ms: float = 50.0,
    ):
        """sync_interval_ms bounds the group-commit loss window IN TIME as
        well as in records: an acknowledged append is fsync'd within
        sync_interval_ms even if fewer than sync_every records follow
        (reference: include/yams/wal/wal_manager.h:32-60 — bounded group
        commit). 0 disables the flusher (count-only syncing, the pre-r5
        behavior, up to sync_every-1 acknowledged ops lost on power cut)."""
        self.dir = pathlib.Path(wal_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = segment_bytes
        self.sync_every = sync_every
        self.sync_interval_ms = sync_interval_ms
        self._lock = threading.RLock()
        self._seq = 0
        self._pending = 0
        self._pending_since: float | None = None  # first unsynced append ts
        segs = self._segments()
        self._seg_index = (int(segs[-1].stem) + 1) if segs else 1
        self._fh = None
        self._open_segment()
        self._flush_cv = threading.Condition(self._lock)
        self._closing = False
        self._flusher: threading.Thread | None = None
        if sync_interval_ms > 0:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="wal-flusher", daemon=True)
            self._flusher.start()

    def _flush_loop(self) -> None:
        """Deadline flusher: fsync once the oldest unsynced record has been
        pending for sync_interval_ms."""
        interval = self.sync_interval_ms / 1e3
        with self._flush_cv:
            while not self._closing:
                if self._pending_since is None:
                    self._flush_cv.wait()
                    continue
                deadline = self._pending_since + interval
                now = time.monotonic()
                if now < deadline:
                    self._flush_cv.wait(deadline - now)
                    continue
                if self._pending and self._fh is not None:
                    self.sync()

    def _segments(self) -> list[pathlib.Path]:
        return sorted(self.dir.glob("*.wal"))

    def _open_segment(self) -> None:
        if self._fh:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        path = self.dir / f"{self._seg_index:08d}.wal"
        self._fh = open(path, "ab")
        self._seg_index += 1

    def append(self, op: str, **fields: Any) -> int:
        """Append one record; returns its sequence number."""
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "op": op, **fields}
            payload = msgpack.packb(rec, use_bin_type=True)
            self._fh.write(_FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF))
            self._fh.write(payload)
            self._pending += 1
            if self._pending == 1:
                self._pending_since = time.monotonic()
                if self._flusher is not None:
                    self._flush_cv.notify()
            if self._pending >= self.sync_every:
                self.sync()
            if self._fh.tell() >= self.segment_bytes:
                self._open_segment()
            return self._seq

    def sync(self) -> None:
        with self._lock:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._pending = 0
            self._pending_since = None

    def replay(self) -> Iterator[dict[str, Any]]:
        """Yield all intact records across segments; stop a segment at the
        first torn/corrupt frame (crash tail)."""
        for seg in self._segments():
            with open(seg, "rb") as f:
                while True:
                    head = f.read(_FRAME.size)
                    if len(head) < _FRAME.size:
                        break
                    length, crc = _FRAME.unpack(head)
                    payload = f.read(length)
                    if len(payload) < length or zlib.crc32(payload) & 0xFFFFFFFF != crc:
                        break  # torn write: ignore the rest of this segment
                    rec = msgpack.unpackb(payload, raw=False)
                    self._seq = max(self._seq, rec.get("seq", 0))
                    yield rec

    def checkpoint(self, apply_fn: Callable[[], None] | None = None) -> None:
        """Mark state as durable and truncate old segments.

        apply_fn (e.g. sqlite commit/fsync) runs before truncation so the WAL
        is only discarded once downstream state is safe.
        """
        with self._lock:
            self.sync()
            if apply_fn:
                apply_fn()
            self.append(OP_CHECKPOINT)
            self.sync()
            current = self._segments()[-1:]
            for seg in self._segments():
                if seg not in current:
                    seg.unlink()

    def close(self) -> None:
        with self._lock:
            self._closing = True
            self._flush_cv.notify_all()
            if self._fh:
                self.sync()
                self._fh.close()
                self._fh = None
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
            self._flusher = None
