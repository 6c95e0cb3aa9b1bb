"""SQLite wrapper + versioned migration framework.

Copied from yams_tpu/metadata/db.py (the port imports nothing of yams_tpu):
the same schema and migrations, and the connection options (WAL, NORMAL
sync, foreign keys, check_same_thread=False), so a file written by either
package opens in the other and two stores may share one file.

Parity: src/metadata/database.cpp (WAL mode, busy retry) and
src/metadata/migration.cpp (versioned up-migrations creating documents,
document_content, metadata, documents_fts w/ unicode61 tokenchars '_-',
KG tables, path tree, tree snapshots, embedding status, vector model registry).
"""

from __future__ import annotations

import pathlib
import sqlite3
import threading
import time

from ..core.errors import DatabaseError

MIGRATIONS: list[tuple[int, str]] = [
    (1, """
CREATE TABLE documents (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    file_path TEXT NOT NULL,
    file_name TEXT NOT NULL,
    file_extension TEXT NOT NULL DEFAULT '',
    file_size INTEGER NOT NULL DEFAULT 0,
    sha256_hash TEXT NOT NULL,
    mime_type TEXT NOT NULL DEFAULT 'application/octet-stream',
    created_time REAL NOT NULL,
    modified_time REAL NOT NULL,
    indexed_time REAL NOT NULL,
    content_extracted INTEGER NOT NULL DEFAULT 0,
    extraction_status TEXT NOT NULL DEFAULT 'pending'
);
CREATE UNIQUE INDEX idx_documents_path ON documents(file_path);
CREATE INDEX idx_documents_hash ON documents(sha256_hash);
CREATE INDEX idx_documents_name ON documents(file_name);
CREATE TABLE document_content (
    document_id INTEGER PRIMARY KEY REFERENCES documents(id) ON DELETE CASCADE,
    content_text TEXT NOT NULL DEFAULT '',
    content_length INTEGER NOT NULL DEFAULT 0,
    extraction_method TEXT NOT NULL DEFAULT ''
);
CREATE TABLE metadata (
    document_id INTEGER NOT NULL REFERENCES documents(id) ON DELETE CASCADE,
    key TEXT NOT NULL,
    value TEXT NOT NULL DEFAULT '',
    PRIMARY KEY (document_id, key)
);
CREATE INDEX idx_metadata_key_value ON metadata(key, value);
"""),
    (2, """
CREATE VIRTUAL TABLE documents_fts USING fts5(
    title, content,
    tokenize = "unicode61 tokenchars '_-'"
);
"""),
    (3, """
CREATE TABLE kg_nodes (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    node_key TEXT NOT NULL UNIQUE,
    label TEXT NOT NULL DEFAULT '',
    type TEXT NOT NULL DEFAULT 'entity',
    properties TEXT NOT NULL DEFAULT '{}',
    created_time REAL NOT NULL
);
CREATE TABLE kg_aliases (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    node_id INTEGER NOT NULL REFERENCES kg_nodes(id) ON DELETE CASCADE,
    alias TEXT NOT NULL,
    source TEXT NOT NULL DEFAULT ''
);
CREATE INDEX idx_kg_aliases_alias ON kg_aliases(alias);
CREATE INDEX idx_kg_aliases_node ON kg_aliases(node_id);
CREATE TABLE kg_edges (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    src_node_id INTEGER NOT NULL REFERENCES kg_nodes(id) ON DELETE CASCADE,
    dst_node_id INTEGER NOT NULL REFERENCES kg_nodes(id) ON DELETE CASCADE,
    relation TEXT NOT NULL DEFAULT 'related',
    weight REAL NOT NULL DEFAULT 1.0,
    properties TEXT NOT NULL DEFAULT '{}'
);
CREATE INDEX idx_kg_edges_src ON kg_edges(src_node_id);
CREATE INDEX idx_kg_edges_dst ON kg_edges(dst_node_id);
CREATE UNIQUE INDEX idx_kg_edges_uniq ON kg_edges(src_node_id, dst_node_id, relation);
CREATE TABLE doc_entities (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    document_id INTEGER NOT NULL REFERENCES documents(id) ON DELETE CASCADE,
    node_id INTEGER NOT NULL REFERENCES kg_nodes(id) ON DELETE CASCADE,
    entity_text TEXT NOT NULL DEFAULT '',
    confidence REAL NOT NULL DEFAULT 1.0
);
CREATE INDEX idx_doc_entities_doc ON doc_entities(document_id);
CREATE INDEX idx_doc_entities_node ON doc_entities(node_id);
"""),
    (4, """
CREATE TABLE path_tree_nodes (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    parent_id INTEGER REFERENCES path_tree_nodes(id) ON DELETE CASCADE,
    name TEXT NOT NULL,
    full_path TEXT NOT NULL UNIQUE,
    doc_count INTEGER NOT NULL DEFAULT 0
);
CREATE INDEX idx_path_tree_parent ON path_tree_nodes(parent_id);
"""),
    (5, """
CREATE TABLE tree_snapshots (
    snapshot_id TEXT PRIMARY KEY,
    label TEXT NOT NULL DEFAULT '',
    root_hash TEXT NOT NULL DEFAULT '',
    created_time REAL NOT NULL
);
CREATE TABLE tree_snapshot_entries (
    snapshot_id TEXT NOT NULL REFERENCES tree_snapshots(snapshot_id) ON DELETE CASCADE,
    path TEXT NOT NULL,
    hash TEXT NOT NULL,
    is_dir INTEGER NOT NULL DEFAULT 0,
    size INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (snapshot_id, path)
);
"""),
    (6, """
CREATE TABLE embedding_status (
    document_id INTEGER PRIMARY KEY REFERENCES documents(id) ON DELETE CASCADE,
    status TEXT NOT NULL DEFAULT 'pending',
    model_id TEXT NOT NULL DEFAULT '',
    updated_time REAL NOT NULL
);
CREATE TABLE vector_models (
    model_id TEXT PRIMARY KEY,
    dim INTEGER NOT NULL,
    space_id TEXT NOT NULL DEFAULT '',
    created_time REAL NOT NULL
);
"""),
    (7, """
CREATE TABLE sessions (
    name TEXT PRIMARY KEY,
    created_time REAL NOT NULL,
    pinned TEXT NOT NULL DEFAULT '[]',
    metadata TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE hotzones (
    document_id INTEGER PRIMARY KEY REFERENCES documents(id) ON DELETE CASCADE,
    score REAL NOT NULL DEFAULT 0.0,
    last_touch REAL NOT NULL
);
"""),
]

SCHEMA_VERSION = MIGRATIONS[-1][0]


class Database:
    """Single-connection SQLite handle with WAL mode and busy retry."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(str(self.path), check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._migrate()

    @property
    def conn(self) -> sqlite3.Connection:
        return self._conn

    @property
    def lock(self) -> threading.RLock:
        return self._lock

    def _migrate(self) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS schema_version"
                " (version INTEGER NOT NULL, applied_at REAL NOT NULL)"
            )
            row = self._conn.execute(
                "SELECT MAX(version) FROM schema_version"
            ).fetchone()
            current = row[0] or 0
            if current == 0:
                # a salvaged DB may carry the schema but have lost its
                # schema_version rows: infer the version from marker tables
                markers = {
                    1: "documents", 2: "documents_fts", 3: "kg_nodes",
                    4: "path_tree_nodes", 5: "tree_snapshots",
                    6: "embedding_status", 7: "sessions",
                }
                present = {
                    v for v, marker in markers.items()
                    if self._conn.execute(
                        "SELECT 1 FROM sqlite_master WHERE name=?", (marker,)
                    ).fetchone()
                }
                current = max(present, default=0)
                # recreate tables salvage dropped (e.g. FTS shadow tables)
                for version, sql in MIGRATIONS:
                    if version <= current and version not in present:
                        try:
                            self._conn.executescript(sql)
                        except sqlite3.Error:
                            pass
                if current:
                    self._conn.execute(
                        "INSERT INTO schema_version VALUES (?, ?)",
                        (current, time.time()),
                    )
            for version, sql in MIGRATIONS:
                if version > current:
                    try:
                        self._conn.executescript(sql)
                    except sqlite3.Error as e:
                        raise DatabaseError(f"migration v{version} failed: {e}")
                    self._conn.execute(
                        "INSERT INTO schema_version VALUES (?, ?)",
                        (version, time.time()),
                    )

    def execute(self, sql: str, params=()) -> sqlite3.Cursor:
        with self._lock:
            for attempt in range(5):
                try:
                    return self._conn.execute(sql, params)
                except sqlite3.OperationalError as e:
                    if "locked" in str(e) and attempt < 4:
                        time.sleep(0.05 * (attempt + 1))
                        continue
                    raise DatabaseError(str(e))

    def close(self) -> None:
        self._conn.close()

    def integrity_check(self) -> bool:
        with self._lock:
            row = self._conn.execute("PRAGMA integrity_check").fetchone()
        return row is not None and row[0] == "ok"

    def vacuum(self) -> None:
        with self._lock:
            self._conn.execute("VACUUM")
