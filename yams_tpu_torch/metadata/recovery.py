"""SQLite corruption detection + salvage.

Parity: src/daemon/components/db_recovery.cpp / db_salvage.cpp — detect a
corrupt metadata DB, salvage readable rows into a fresh DB (".recover"-style:
copy table-by-table, skipping unreadable rows), keep the damaged original as
a .corrupt backup.

Copied from yams_tpu/metadata/recovery.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import pathlib
import shutil
import sqlite3
import time


def is_corrupt(db_path: str | pathlib.Path) -> bool:
    try:
        conn = sqlite3.connect(str(db_path))
        try:
            row = conn.execute("PRAGMA integrity_check").fetchone()
            return row is None or row[0] != "ok"
        finally:
            conn.close()
    except sqlite3.Error:
        return True


def salvage(db_path: str | pathlib.Path) -> dict:
    """Rebuild a damaged DB from whatever rows are still readable.

    Returns {tables, rows_copied, rows_lost, backup}. The fresh DB has the
    same schema (from sqlite_master where readable); the caller re-runs
    migrations afterwards to fill any gaps.
    """
    db_path = pathlib.Path(db_path)
    backup = db_path.with_suffix(db_path.suffix + f".corrupt-{int(time.time())}")
    fresh = db_path.with_suffix(db_path.suffix + ".salvage")
    if fresh.exists():
        fresh.unlink()

    report = {"tables": 0, "rows_copied": 0, "rows_lost": 0, "backup": str(backup)}
    src = sqlite3.connect(str(db_path))
    dst = sqlite3.connect(str(fresh))
    try:
        try:
            schema = src.execute(
                "SELECT name, sql FROM sqlite_master"
                " WHERE type='table' AND sql IS NOT NULL"
                " AND name NOT LIKE 'sqlite_%'"
            ).fetchall()
        except sqlite3.Error:
            schema = []
        for name, sql in schema:
            if name.endswith("_fts") or "_fts_" in name:
                continue  # FTS shadow tables: rebuilt via repair_fts5
            try:
                dst.execute(sql)
            except sqlite3.Error:
                continue
            report["tables"] += 1
            copied = 0
            try:
                cur = src.execute(f"SELECT * FROM \"{name}\"")
                while True:
                    try:
                        row = cur.fetchone()
                    except sqlite3.Error:
                        report["rows_lost"] += 1
                        break  # cursor is dead past the corrupt page
                    if row is None:
                        break
                    try:
                        ph = ",".join("?" * len(row))
                        dst.execute(f"INSERT INTO \"{name}\" VALUES ({ph})", row)
                        copied += 1
                    except sqlite3.Error:
                        report["rows_lost"] += 1
            except sqlite3.Error:
                report["rows_lost"] += 1
            if copied == 0:
                # bulk cursor died at the first corrupt page: probe per rowid,
                # which walks the b-tree point-wise and skips dead pages
                misses = 0
                rowid = 0
                while misses < 2048:
                    rowid += 1
                    try:
                        row = src.execute(
                            f"SELECT * FROM \"{name}\" WHERE rowid=?", (rowid,)
                        ).fetchone()
                    except sqlite3.Error:
                        misses += 1
                        continue
                    if row is None:
                        misses += 1
                        continue
                    misses = 0
                    try:
                        ph = ",".join("?" * len(row))
                        dst.execute(f"INSERT INTO \"{name}\" VALUES ({ph})", row)
                        copied += 1
                    except sqlite3.Error:
                        report["rows_lost"] += 1
            report["rows_copied"] += copied
        dst.commit()
    finally:
        src.close()
        dst.close()

    shutil.move(str(db_path), str(backup))
    for sidecar in (db_path.parent.glob(db_path.name + "-wal"),
                    db_path.parent.glob(db_path.name + "-shm")):
        for f in sidecar:
            f.unlink(missing_ok=True)
    shutil.move(str(fresh), str(db_path))
    return report


def detect_and_salvage(db_path: str | pathlib.Path) -> dict | None:
    """Salvage iff corrupt. Returns the report, or None if healthy."""
    if not pathlib.Path(db_path).exists():
        return None
    if not is_corrupt(db_path):
        return None
    return salvage(db_path)
