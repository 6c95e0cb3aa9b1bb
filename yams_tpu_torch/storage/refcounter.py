"""SQLite-backed block reference counting + manifest persistence.

Parity: src/storage/reference_counter.cpp + sql/reference_schema.sql
(block_references table, transactional batches, audit trail) and
src/manifest/manifest_manager.cpp (ordered chunk lists). Both live in one
storage.db so a store() is a single SQLite transaction.

Copied from yams_tpu/storage/refcounter.py (the port imports
nothing of yams_tpu).
"""

from __future__ import annotations

import pathlib
import sqlite3
import threading
import time

import msgpack

from ..core.errors import NotFoundError
from ..core.types import Manifest

_SCHEMA = """
PRAGMA journal_mode=WAL;
CREATE TABLE IF NOT EXISTS block_references (
    block_hash TEXT PRIMARY KEY,
    ref_count INTEGER NOT NULL DEFAULT 0,
    block_size INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    last_accessed REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_blockref_zero
    ON block_references(ref_count) WHERE ref_count = 0;
CREATE TABLE IF NOT EXISTS manifests (
    content_hash TEXT PRIMARY KEY,
    total_size INTEGER NOT NULL,
    chunk_count INTEGER NOT NULL,
    ref_count INTEGER NOT NULL DEFAULT 1,
    payload BLOB NOT NULL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS ref_audit (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    ts REAL NOT NULL,
    op TEXT NOT NULL,
    block_hash TEXT NOT NULL,
    delta INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS ref_meta (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
"""


class ReferenceCounter:
    def __init__(self, db_path: str | pathlib.Path, audit: bool = False):
        self.db_path = pathlib.Path(db_path)
        self.db_path.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(str(self.db_path), check_same_thread=False)
        self._conn.executescript(_SCHEMA)
        self._lock = threading.RLock()
        self.audit = audit

    def close(self) -> None:
        self._conn.close()

    # -- WAL coupling: applied-sequence watermark (crash-recovery idempotence) --
    def last_applied_seq(self) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM ref_meta WHERE key='last_wal_seq'"
            ).fetchone()
        return int(row[0]) if row else 0

    def _set_seq_tx(self, seq: int | None) -> None:
        if seq is not None:
            self._conn.execute(
                "INSERT OR REPLACE INTO ref_meta VALUES ('last_wal_seq', ?)",
                (str(seq),),
            )

    # -- chunk refcounts -------------------------------------------------------
    def increment_batch(
        self, refs: list[tuple[str, int]], wal_seq: int | None = None
    ) -> None:
        """refs: [(block_hash, size)] — one transaction. wal_seq records the
        WAL watermark in the SAME transaction so replay is exactly-once."""
        now = time.time()
        with self._lock, self._conn:
            self._set_seq_tx(wal_seq)
            self._conn.executemany(
                """INSERT INTO block_references
                   (block_hash, ref_count, block_size, created_at, last_accessed)
                   VALUES (?, 1, ?, ?, ?)
                   ON CONFLICT(block_hash) DO UPDATE SET
                     ref_count = ref_count + 1, last_accessed = excluded.last_accessed""",
                [(h, s, now, now) for h, s in refs],
            )
            if self.audit:
                self._conn.executemany(
                    "INSERT INTO ref_audit (ts, op, block_hash, delta) VALUES (?,?,?,1)",
                    [(now, "inc", h) for h, _ in refs],
                )

    def decrement_batch(self, hashes: list[str], wal_seq: int | None = None) -> None:
        now = time.time()
        with self._lock, self._conn:
            self._set_seq_tx(wal_seq)
            self._conn.executemany(
                """UPDATE block_references
                   SET ref_count = MAX(ref_count - 1, 0), last_accessed = ?
                   WHERE block_hash = ?""",
                [(now, h) for h in hashes],
            )
            if self.audit:
                self._conn.executemany(
                    "INSERT INTO ref_audit (ts, op, block_hash, delta) VALUES (?,?,?,-1)",
                    [(now, "dec", h) for h in hashes],
                )

    def ref_count(self, h: str) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT ref_count FROM block_references WHERE block_hash=?", (h,)
            ).fetchone()
        return row[0] if row else 0

    def unreferenced(self, limit: int = 10_000) -> list[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT block_hash FROM block_references WHERE ref_count=0 LIMIT ?",
                (limit,),
            ).fetchall()
        return [r[0] for r in rows]

    def forget(self, hashes: list[str]) -> None:
        with self._lock, self._conn:
            self._conn.executemany(
                "DELETE FROM block_references WHERE block_hash=? AND ref_count=0",
                [(h,) for h in hashes],
            )

    def known_blocks(self) -> set[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT block_hash FROM block_references WHERE ref_count > 0"
            ).fetchall()
        return {r[0] for r in rows}

    def stats(self) -> dict:
        with self._lock:
            total, blocks = self._conn.execute(
                "SELECT COALESCE(SUM(block_size),0), COUNT(*) FROM block_references"
                " WHERE ref_count > 0"
            ).fetchone()
            manifests = self._conn.execute(
                "SELECT COUNT(*) FROM manifests WHERE ref_count > 0"
            ).fetchone()[0]
        return {"unique_blocks": blocks, "unique_bytes": total, "manifests": manifests}

    # -- atomic store commit (refcounts + manifest in ONE transaction) ----------
    def apply_commit(
        self, refs: list[tuple[str, int]], manifest: Manifest,
        wal_seq: int | None = None,
    ) -> None:
        """The sqlite side of ContentStore.store: chunk refcount increments +
        manifest upsert + WAL watermark, one transaction (replay-safe)."""
        now = time.time()
        payload = msgpack.packb(manifest.to_dict(), use_bin_type=True)
        with self._lock, self._conn:
            self._set_seq_tx(wal_seq)
            self._conn.executemany(
                """INSERT INTO block_references
                   (block_hash, ref_count, block_size, created_at, last_accessed)
                   VALUES (?, 1, ?, ?, ?)
                   ON CONFLICT(block_hash) DO UPDATE SET
                     ref_count = ref_count + 1, last_accessed = excluded.last_accessed""",
                [(h, s, now, now) for h, s in refs],
            )
            self._conn.execute(
                """INSERT INTO manifests (content_hash, total_size, chunk_count,
                   ref_count, payload, created_at) VALUES (?,?,?,1,?,?)
                   ON CONFLICT(content_hash) DO UPDATE SET
                     ref_count = ref_count + 1""",
                (manifest.content_hash, manifest.total_size, len(manifest.chunks),
                 payload, now),
            )

    def apply_remove(self, content_hash: str, wal_seq: int | None = None) -> bool:
        """The sqlite side of ContentStore.remove: manifest release + chunk
        decrements, one transaction. Returns False if the manifest is absent."""
        now = time.time()
        with self._lock, self._conn:
            self._set_seq_tx(wal_seq)
            row = self._conn.execute(
                "SELECT ref_count, payload FROM manifests WHERE content_hash=?",
                (content_hash,),
            ).fetchone()
            if row is None or row[0] <= 0:
                return False
            new_count = row[0] - 1
            if new_count == 0:
                self._conn.execute(
                    "DELETE FROM manifests WHERE content_hash=?", (content_hash,)
                )
            else:
                self._conn.execute(
                    "UPDATE manifests SET ref_count=? WHERE content_hash=?",
                    (new_count, content_hash),
                )
            m = Manifest.from_dict(msgpack.unpackb(row[1], raw=False))
            self._conn.executemany(
                """UPDATE block_references
                   SET ref_count = MAX(ref_count - 1, 0), last_accessed = ?
                   WHERE block_hash = ?""",
                [(now, c.hash) for c in m.chunks],
            )
            return True

    # -- manifests ---------------------------------------------------------------
    def store_manifest(self, m: Manifest) -> bool:
        """Persist manifest; returns False if already present (content dedup)."""
        payload = msgpack.packb(m.to_dict(), use_bin_type=True)
        with self._lock, self._conn:
            cur = self._conn.execute(
                "SELECT ref_count FROM manifests WHERE content_hash=?",
                (m.content_hash,),
            ).fetchone()
            if cur is not None:
                self._conn.execute(
                    "UPDATE manifests SET ref_count = ref_count + 1 WHERE content_hash=?",
                    (m.content_hash,),
                )
                return False
            self._conn.execute(
                "INSERT INTO manifests (content_hash, total_size, chunk_count,"
                " ref_count, payload, created_at) VALUES (?,?,?,1,?,?)",
                (m.content_hash, m.total_size, len(m.chunks), payload, time.time()),
            )
            return True

    def get_manifest(self, content_hash: str) -> Manifest:
        with self._lock:
            row = self._conn.execute(
                "SELECT payload FROM manifests WHERE content_hash=? AND ref_count>0",
                (content_hash,),
            ).fetchone()
        if row is None:
            raise NotFoundError(f"manifest not found: {content_hash}")
        return Manifest.from_dict(msgpack.unpackb(row[0], raw=False))

    def has_manifest(self, content_hash: str) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM manifests WHERE content_hash=? AND ref_count>0",
                (content_hash,),
            ).fetchone()
        return row is not None

    def release_manifest(self, content_hash: str) -> Manifest | None:
        """Decrement manifest refcount; return the manifest when it hits zero."""
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT ref_count, payload FROM manifests WHERE content_hash=?",
                (content_hash,),
            ).fetchone()
            if row is None or row[0] <= 0:
                raise NotFoundError(f"manifest not found: {content_hash}")
            new_count = row[0] - 1
            self._conn.execute(
                "UPDATE manifests SET ref_count=? WHERE content_hash=?",
                (new_count, content_hash),
            )
            if new_count == 0:
                self._conn.execute(
                    "DELETE FROM manifests WHERE content_hash=?", (content_hash,)
                )
                return Manifest.from_dict(msgpack.unpackb(row[1], raw=False))
            return None

    def iter_manifests(self):
        with self._lock:
            rows = self._conn.execute(
                "SELECT payload FROM manifests WHERE ref_count>0"
            ).fetchall()
        for (payload,) in rows:
            yield Manifest.from_dict(msgpack.unpackb(payload, raw=False))
