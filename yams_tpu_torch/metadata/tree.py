"""Merkle tree snapshots of directory state + structural diff.

Parity: include/yams/metadata/tree_builder.h:124-145 (TreeBuilder) and
tree_differ.h:111-136 (TreeDiffer with rename detection via content hash).

Copied from yams_tpu/metadata/tree.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
import uuid

from .db import Database


@dataclasses.dataclass(slots=True)
class TreeEntry:
    path: str
    hash: str
    is_dir: bool = False
    size: int = 0


@dataclasses.dataclass(slots=True)
class TreeChange:
    type: str  # added | deleted | modified | renamed
    path: str
    old_path: str = ""
    hash: str = ""


class TreeBuilder:
    """Builds and persists Merkle snapshots from (path, content_hash, size) sets."""

    def __init__(self, db: Database):
        self.db = db

    @staticmethod
    def compute_root(entries: list[TreeEntry]) -> str:
        h = hashlib.sha256()
        for e in sorted(entries, key=lambda x: x.path):
            h.update(f"{e.path}\x00{e.hash}\x00{e.size}\n".encode())
        return h.hexdigest()

    def snapshot(
        self, entries: list[TreeEntry], label: str = "", snapshot_id: str | None = None
    ) -> str:
        sid = snapshot_id or uuid.uuid4().hex[:16]
        root = self.compute_root(entries)
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                "INSERT OR REPLACE INTO tree_snapshots VALUES (?,?,?,?)",
                (sid, label, root, time.time()),
            )
            self.db.conn.execute(
                "DELETE FROM tree_snapshot_entries WHERE snapshot_id=?", (sid,)
            )
            self.db.conn.executemany(
                "INSERT INTO tree_snapshot_entries VALUES (?,?,?,?,?)",
                [(sid, e.path, e.hash, int(e.is_dir), e.size) for e in entries],
            )
        return sid

    def get_snapshot(self, snapshot_id: str) -> list[TreeEntry]:
        rows = self.db.execute(
            "SELECT path, hash, is_dir, size FROM tree_snapshot_entries"
            " WHERE snapshot_id=? ORDER BY path",
            (snapshot_id,),
        ).fetchall()
        return [TreeEntry(r[0], r[1], bool(r[2]), r[3]) for r in rows]

    def list_snapshots(self) -> list[dict]:
        rows = self.db.execute(
            "SELECT snapshot_id, label, root_hash, created_time FROM tree_snapshots"
            " ORDER BY created_time"
        ).fetchall()
        return [
            {"id": r[0], "label": r[1], "root": r[2], "created": r[3]} for r in rows
        ]


class TreeDiffer:
    """Structural diff between two snapshots with rename detection."""

    @staticmethod
    def diff(old: list[TreeEntry], new: list[TreeEntry]) -> list[TreeChange]:
        old_by_path = {e.path: e for e in old}
        new_by_path = {e.path: e for e in new}
        changes: list[TreeChange] = []
        deleted = {p: e for p, e in old_by_path.items() if p not in new_by_path}
        added = {p: e for p, e in new_by_path.items() if p not in old_by_path}

        # rename detection: same content hash moved to a new path
        deleted_by_hash: dict[str, list[str]] = {}
        for p, e in deleted.items():
            if not e.is_dir:
                deleted_by_hash.setdefault(e.hash, []).append(p)
        consumed_old: set[str] = set()
        for p, e in sorted(added.items()):
            cands = deleted_by_hash.get(e.hash, [])
            cand = next((c for c in cands if c not in consumed_old), None)
            if cand is not None and not e.is_dir:
                consumed_old.add(cand)
                changes.append(TreeChange("renamed", p, old_path=cand, hash=e.hash))
            else:
                changes.append(TreeChange("added", p, hash=e.hash))
        for p, e in sorted(deleted.items()):
            if p not in consumed_old:
                changes.append(TreeChange("deleted", p, hash=e.hash))
        for p in sorted(set(old_by_path) & set(new_by_path)):
            if old_by_path[p].hash != new_by_path[p].hash:
                changes.append(TreeChange("modified", p, hash=new_by_path[p].hash))
        return changes
