"""MetadataRepository: CRUD + queries over documents, FTS5, tags, path tree.

Parity: include/yams/metadata/metadata_repository.h:562-603 (single-transaction
batched inserts) and src/metadata/repository/search_ops.cpp:176,471 (FTS5 MATCH
with bm25(documents_fts, 1.0, 10.0) column weighting). The FTS5 path doubles as
the host-side parity oracle for the device BM25 kernel.

Copied from yams_tpu/metadata/repository.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time

from ..core.errors import NotFoundError
from ..core.types import DocumentInfo
from .db import Database

_TAG_PREFIX = "tag:"


@dataclasses.dataclass(slots=True)
class FtsResult:
    document_id: int
    score: float  # higher is better (negated sqlite bm25)
    title: str = ""
    snippet: str = ""


def _row_to_doc(row) -> DocumentInfo:
    return DocumentInfo(
        id=row["id"],
        file_path=row["file_path"],
        file_name=row["file_name"],
        file_extension=row["file_extension"],
        file_size=row["file_size"],
        sha256_hash=row["sha256_hash"],
        mime_type=row["mime_type"],
        created_time=row["created_time"],
        modified_time=row["modified_time"],
        indexed_time=row["indexed_time"],
        content_extracted=bool(row["content_extracted"]),
        extraction_status=row["extraction_status"],
    )


def sanitize_fts_query(query: str) -> str:
    """Turn free text into a safe FTS5 MATCH expression (implicit AND)."""
    terms = re.findall(r"[\w\-]+", query, re.UNICODE)
    terms = [t for t in terms if t not in ("AND", "OR", "NOT", "NEAR")]
    return " ".join(f'"{t}"' for t in terms) if terms else '""'


class MetadataRepository:
    # serving hydration caches: bounded FIFO maps so the hot search path
    # (get_document/get_content per hit) costs a dict lookup instead of 3-4
    # SQLite queries. The daemon is the single writer; every mutating method
    # below invalidates the touched id.
    DOC_CACHE_MAX = 65536
    CONTENT_CACHE_MAX_CHARS = 64 * 1024 * 1024

    def __init__(self, db: Database):
        self.db = db
        self._doc_cache: dict[int, DocumentInfo] = {}
        self._content_cache: dict[int, str] = {}
        self._content_cache_chars = 0
        # fill/evict guard: concurrent reader threads (daemon search pool)
        # race each other at the cap and race writer-side _invalidate();
        # unguarded, two threads can pop the same FIFO head (KeyError)
        self._cache_lock = threading.Lock()

    def _invalidate(self, doc_id: int) -> None:
        with self._cache_lock:
            self._doc_cache.pop(doc_id, None)
            old = self._content_cache.pop(doc_id, None)
            if old is not None:
                self._content_cache_chars -= len(old)

    def _cache_doc(self, doc_id: int, doc: "DocumentInfo") -> None:
        with self._cache_lock:
            if len(self._doc_cache) >= self.DOC_CACHE_MAX:
                self._doc_cache.pop(next(iter(self._doc_cache)), None)
            self._doc_cache[doc_id] = doc

    def _clone_doc(self, doc: DocumentInfo) -> DocumentInfo:
        out = dataclasses.replace(doc)
        out.tags = list(doc.tags)
        out.metadata = dict(doc.metadata)
        return out

    # -- documents -----------------------------------------------------------
    def insert_document(
        self,
        info: DocumentInfo,
        content_text: str | None = None,
        title: str | None = None,
    ) -> int:
        """Insert doc + content + FTS + tags + metadata + path tree: one tx."""
        with self.db.lock, self.db.conn:
            pre = self.db.conn.execute(
                "SELECT id FROM documents WHERE file_path=?",
                (info.file_path,),
            ).fetchone()
            cur = self.db.conn.execute(
                """INSERT INTO documents (file_path, file_name, file_extension,
                   file_size, sha256_hash, mime_type, created_time, modified_time,
                   indexed_time, content_extracted, extraction_status)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?)
                   ON CONFLICT(file_path) DO UPDATE SET
                     sha256_hash=excluded.sha256_hash,
                     file_size=excluded.file_size,
                     mime_type=excluded.mime_type,
                     modified_time=excluded.modified_time,
                     indexed_time=excluded.indexed_time,
                     content_extracted=excluded.content_extracted,
                     extraction_status=excluded.extraction_status
                   RETURNING id""",
                (
                    info.file_path, info.file_name, info.file_extension,
                    info.file_size, info.sha256_hash, info.mime_type,
                    info.created_time, info.modified_time, info.indexed_time,
                    int(info.content_extracted), info.extraction_status,
                ),
            )
            # lastrowid is stale when the DO UPDATE branch fires (it would
            # point at the last real insert on this connection — another
            # document), so take the id from RETURNING instead.
            doc_id = cur.fetchone()[0]
            info.id = doc_id
            if content_text is not None:
                self._set_content_tx(doc_id, content_text, title or info.file_name)
            elif pre is not None:
                # re-ingest of an existing path with unextractable content:
                # the previous version's text + FTS row describe content
                # that no longer exists — drop them or search/get_text/
                # re-embedding would serve the OLD version's text
                self.db.conn.execute(
                    "DELETE FROM document_content WHERE document_id=?",
                    (doc_id,))
                self.db.conn.execute(
                    "DELETE FROM documents_fts WHERE rowid=?", (doc_id,))
            for tag in info.tags:
                self.db.conn.execute(
                    "INSERT OR REPLACE INTO metadata VALUES (?,?,?)",
                    (doc_id, _TAG_PREFIX + tag, ""),
                )
            for k, v in info.metadata.items():
                self.db.conn.execute(
                    "INSERT OR REPLACE INTO metadata VALUES (?,?,?)", (doc_id, k, v)
                )
            if pre is None:
                # count each path once: an upsert of an existing path must
                # not re-increment ancestor doc_counts (delete decrements
                # once, so repeated re-ingests would drift counts upward
                # forever and skew the path_tree_weight ranking signal)
                self._upsert_path_tree_tx(info.file_path)
            self.db.conn.execute(
                "INSERT OR REPLACE INTO embedding_status VALUES (?,?,?,?)",
                (doc_id, "pending", "", time.time()),
            )
        self._invalidate(doc_id)
        return doc_id

    def _set_content_tx(self, doc_id: int, text: str, title: str) -> None:
        self.db.conn.execute(
            "INSERT OR REPLACE INTO document_content VALUES (?,?,?,?)",
            (doc_id, text, len(text), "inline"),
        )
        self.db.conn.execute("DELETE FROM documents_fts WHERE rowid=?", (doc_id,))
        self.db.conn.execute(
            "INSERT INTO documents_fts (rowid, title, content) VALUES (?,?,?)",
            (doc_id, title, text),
        )
        self.db.conn.execute(
            "UPDATE documents SET content_extracted=1, extraction_status='success'"
            " WHERE id=?",
            (doc_id,),
        )

    def set_content(self, doc_id: int, text: str, title: str = "") -> None:
        with self.db.lock, self.db.conn:
            self._set_content_tx(doc_id, text, title)
        self._invalidate(doc_id)

    def get_content(self, doc_id: int) -> str | None:
        text = self._content_cache.get(doc_id)
        if text is not None:
            return text
        row = self.db.execute(
            "SELECT content_text FROM document_content WHERE document_id=?", (doc_id,)
        ).fetchone()
        if row is None or row[0] is None:
            return None
        text = row[0]
        if len(text) < self.CONTENT_CACHE_MAX_CHARS // 4:
            with self._cache_lock:
                while (self._content_cache_chars + len(text)
                       > self.CONTENT_CACHE_MAX_CHARS and self._content_cache):
                    old = self._content_cache.pop(
                        next(iter(self._content_cache)), None)
                    if old is not None:
                        self._content_cache_chars -= len(old)
                self._content_cache[doc_id] = text
                self._content_cache_chars += len(text)
        return text

    def get_document(self, doc_id: int) -> DocumentInfo:
        doc = self._doc_cache.get(doc_id)
        if doc is not None:
            return self._clone_doc(doc)
        row = self.db.execute("SELECT * FROM documents WHERE id=?", (doc_id,)).fetchone()
        if row is None:
            raise NotFoundError(f"document {doc_id} not found")
        doc = _row_to_doc(row)
        doc.tags = self.get_tags(doc_id)
        doc.metadata = self.get_metadata(doc_id)
        self._cache_doc(doc_id, doc)
        return self._clone_doc(doc)

    def get_documents(self, doc_ids: list[int],
                      clone: bool = True) -> dict[int, DocumentInfo]:
        """Batched get_document: cached ids clone straight from the doc
        cache; the rest resolve with ONE documents IN-query + ONE metadata
        IN-query per <=500-id chunk. Search hydration calls this once per
        response window instead of 3 sqlite round trips per hit. Unknown
        ids are simply absent from the returned map (no NotFoundError).

        clone=False returns the CACHED instances — read-only by contract
        (mutating them corrupts the cache). The serving hot path uses it:
        cloning cost ~0.2 ms per search window under profile."""
        out: dict[int, DocumentInfo] = {}
        missing: list[int] = []
        for d in dict.fromkeys(doc_ids):
            doc = self._doc_cache.get(d)
            if doc is not None:
                out[d] = self._clone_doc(doc) if clone else doc
            else:
                missing.append(d)
        for i in range(0, len(missing), 500):
            chunk = missing[i:i + 500]
            ph = ",".join("?" * len(chunk))
            fresh: dict[int, DocumentInfo] = {}
            for row in self.db.execute(
                    f"SELECT * FROM documents WHERE id IN ({ph})",
                    chunk).fetchall():
                doc = _row_to_doc(row)
                fresh[doc.id] = doc
            for did, key, value in self.db.execute(
                    "SELECT document_id, key, value FROM metadata"
                    f" WHERE document_id IN ({ph})", chunk).fetchall():
                doc = fresh.get(did)
                if doc is None:
                    continue
                if key.startswith(_TAG_PREFIX):
                    doc.tags.append(key[len(_TAG_PREFIX):])
                else:
                    doc.metadata[key] = value
            for did, doc in fresh.items():
                doc.tags.sort()
                self._cache_doc(did, doc)
                out[did] = self._clone_doc(doc) if clone else doc
        return out

    def get_by_hash(self, sha256_hash: str) -> list[DocumentInfo]:
        rows = self.db.execute(
            "SELECT * FROM documents WHERE sha256_hash=?", (sha256_hash,)
        ).fetchall()
        return [_row_to_doc(r) for r in rows]

    def get_by_path(self, path: str) -> DocumentInfo | None:
        row = self.db.execute(
            "SELECT * FROM documents WHERE file_path=?", (path,)
        ).fetchone()
        return _row_to_doc(row) if row else None

    def find_by_name(self, name: str) -> list[DocumentInfo]:
        rows = self.db.execute(
            "SELECT * FROM documents WHERE file_name=?", (name,)
        ).fetchall()
        return [_row_to_doc(r) for r in rows]

    def delete_document(self, doc_id: int) -> bool:
        with self.db.lock, self.db.conn:
            doc = self.db.conn.execute(
                "SELECT file_path FROM documents WHERE id=?", (doc_id,)
            ).fetchone()
            if doc is None:
                return False
            self.db.conn.execute("DELETE FROM documents_fts WHERE rowid=?", (doc_id,))
            self.db.conn.execute("DELETE FROM documents WHERE id=?", (doc_id,))
            self._decrement_path_tree_tx(doc["file_path"])
        self._invalidate(doc_id)
        return True

    def list_documents(
        self, limit: int = 100, offset: int = 0, pattern: str | None = None
    ) -> list[DocumentInfo]:
        if pattern:
            like = pattern.replace("*", "%").replace("?", "_")
            rows = self.db.execute(
                "SELECT * FROM documents WHERE file_path LIKE ?"
                " ORDER BY indexed_time DESC LIMIT ? OFFSET ?",
                (like, limit, offset),
            ).fetchall()
        else:
            rows = self.db.execute(
                "SELECT * FROM documents ORDER BY indexed_time DESC LIMIT ? OFFSET ?",
                (limit, offset),
            ).fetchall()
        return [_row_to_doc(r) for r in rows]

    def document_count(self) -> int:
        return self.db.execute("SELECT COUNT(*) FROM documents").fetchone()[0]

    def all_document_ids(self) -> list[int]:
        return [r[0] for r in self.db.execute("SELECT id FROM documents ORDER BY id")]

    # -- FTS5 (host lexical oracle) -------------------------------------------
    def search_fts(
        self, query: str, limit: int = 10, offset: int = 0, raw_match: bool = False
    ) -> list[FtsResult]:
        match = query if raw_match else sanitize_fts_query(query)
        try:
            rows = self.db.execute(
                """SELECT rowid, bm25(documents_fts, 1.0, 10.0) AS rank, title,
                          snippet(documents_fts, 1, '[', ']', '...', 12) AS snip
                   FROM documents_fts WHERE documents_fts MATCH ?
                   ORDER BY rank LIMIT ? OFFSET ?""",
                (match, limit, offset),
            ).fetchall()
        except Exception:
            return []
        # sqlite bm25 is lower-is-better (negative); negate for higher-is-better
        return [
            FtsResult(document_id=r["rowid"], score=-r["rank"], title=r["title"],
                      snippet=r["snip"])
            for r in rows
        ]

    # -- tags + metadata --------------------------------------------------------
    def set_tags(self, doc_id: int, tags: list[str]) -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                "DELETE FROM metadata WHERE document_id=? AND key LIKE 'tag:%'",
                (doc_id,),
            )
            self.db.conn.executemany(
                "INSERT OR REPLACE INTO metadata VALUES (?,?,?)",
                [(doc_id, _TAG_PREFIX + t, "") for t in tags],
            )
        self._doc_cache.pop(doc_id, None)

    def get_tags(self, doc_id: int) -> list[str]:
        rows = self.db.execute(
            "SELECT key FROM metadata WHERE document_id=? AND key LIKE 'tag:%'",
            (doc_id,),
        ).fetchall()
        return sorted(r[0][len(_TAG_PREFIX):] for r in rows)

    def find_by_tags(self, tags: list[str], match_all: bool = False) -> list[int]:
        if not tags:
            return []
        keys = [_TAG_PREFIX + t for t in tags]
        q = ",".join("?" * len(keys))
        rows = self.db.execute(
            f"""SELECT document_id, COUNT(*) AS n FROM metadata
                WHERE key IN ({q}) GROUP BY document_id""",
            keys,
        ).fetchall()
        need = len(tags) if match_all else 1
        return [r[0] for r in rows if r[1] >= need]

    def set_metadata(self, doc_id: int, key: str, value: str) -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                "INSERT OR REPLACE INTO metadata VALUES (?,?,?)", (doc_id, key, value)
            )
        self._doc_cache.pop(doc_id, None)

    def get_metadata(self, doc_id: int) -> dict[str, str]:
        rows = self.db.execute(
            "SELECT key, value FROM metadata WHERE document_id=?"
            " AND key NOT LIKE 'tag:%'",
            (doc_id,),
        ).fetchall()
        return {r[0]: r[1] for r in rows}

    def find_by_metadata(self, key: str, value: str) -> list[int]:
        rows = self.db.execute(
            "SELECT document_id FROM metadata WHERE key=? AND value=?", (key, value)
        ).fetchall()
        return [r[0] for r in rows]

    # -- path tree ----------------------------------------------------------------
    def _path_components(self, path: str) -> list[str]:
        parts = [p for p in path.split("/") if p]
        out, acc = [], ""
        for p in parts:
            acc += "/" + p
            out.append(acc)
        return out

    def _upsert_path_tree_tx(self, path: str) -> None:
        parent_id = None
        for full in self._path_components(path):
            name = full.rsplit("/", 1)[-1]
            self.db.conn.execute(
                """INSERT INTO path_tree_nodes (parent_id, name, full_path, doc_count)
                   VALUES (?,?,?,1)
                   ON CONFLICT(full_path) DO UPDATE SET doc_count = doc_count + 1""",
                (parent_id, name, full),
            )
            parent_id = self.db.conn.execute(
                "SELECT id FROM path_tree_nodes WHERE full_path=?", (full,)
            ).fetchone()[0]

    def _decrement_path_tree_tx(self, path: str) -> None:
        for full in self._path_components(path):
            self.db.conn.execute(
                "UPDATE path_tree_nodes SET doc_count = MAX(doc_count - 1, 0)"
                " WHERE full_path=?",
                (full,),
            )
        self.db.conn.execute("DELETE FROM path_tree_nodes WHERE doc_count = 0")

    def path_tree_children(self, prefix: str = "") -> list[tuple[str, int]]:
        if prefix:
            row = self.db.execute(
                "SELECT id FROM path_tree_nodes WHERE full_path=?", (prefix,)
            ).fetchone()
            if row is None:
                return []
            rows = self.db.execute(
                "SELECT full_path, doc_count FROM path_tree_nodes WHERE parent_id=?"
                " ORDER BY full_path",
                (row[0],),
            ).fetchall()
        else:
            rows = self.db.execute(
                "SELECT full_path, doc_count FROM path_tree_nodes"
                " WHERE parent_id IS NULL ORDER BY full_path"
            ).fetchall()
        return [(r[0], r[1]) for r in rows]

    # -- embedding status ------------------------------------------------------------
    def set_embedding_status(self, doc_id: int, status: str, model_id: str = "") -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                "INSERT OR REPLACE INTO embedding_status VALUES (?,?,?,?)",
                (doc_id, status, model_id, time.time()),
            )

    def docs_pending_embedding(self, limit: int = 1000) -> list[int]:
        rows = self.db.execute(
            "SELECT document_id FROM embedding_status WHERE status='pending' LIMIT ?",
            (limit,),
        ).fetchall()
        return [r[0] for r in rows]

    def register_vector_model(self, model_id: str, dim: int, space_id: str) -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                "INSERT OR REPLACE INTO vector_models VALUES (?,?,?,?)",
                (model_id, dim, space_id, time.time()),
            )

    def latest_vector_model(self) -> tuple[str, int, str] | None:
        """(model_id, dim, space_id) of the corpus's registered embedding
        space, or None on a fresh data dir. The space identity string is the
        reference's guard against mixing embeddings from different models
        (simeon_embedding_backend.cpp space-identity)."""
        row = self.db.execute(
            "SELECT model_id, dim, space_id FROM vector_models"
            " ORDER BY created_time DESC LIMIT 1"
        ).fetchone()
        return (row[0], int(row[1]), row[2]) if row else None

    # -- sessions ----------------------------------------------------------------------
    def upsert_session(self, name: str, pinned: list[str], metadata: dict | None = None) -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                "INSERT OR REPLACE INTO sessions VALUES (?,?,?,?)",
                (name, time.time(), json.dumps(pinned), json.dumps(metadata or {})),
            )

    def get_session(self, name: str) -> tuple[list[str], dict] | None:
        row = self.db.execute(
            "SELECT pinned, metadata FROM sessions WHERE name=?", (name,)
        ).fetchone()
        if row is None:
            return None
        return json.loads(row[0]), json.loads(row[1])

    def list_sessions(self) -> list[str]:
        return [r[0] for r in self.db.execute("SELECT name FROM sessions ORDER BY name")]

    def delete_session(self, name: str) -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.execute("DELETE FROM sessions WHERE name=?", (name,))

    # -- hotzones -------------------------------------------------------------------------
    def touch_hotzone(self, doc_id: int, boost: float = 1.0, half_life_s: float = 86400.0) -> None:
        """Time-decayed usage boost (reference: hotzone_manager.h:15-43)."""
        now = time.time()
        with self.db.lock, self.db.conn:
            row = self.db.conn.execute(
                "SELECT score, last_touch FROM hotzones WHERE document_id=?", (doc_id,)
            ).fetchone()
            if row:
                decayed = row[0] * (0.5 ** ((now - row[1]) / half_life_s))
                score = decayed + boost
            else:
                score = boost
            self.db.conn.execute(
                "INSERT OR REPLACE INTO hotzones VALUES (?,?,?)", (doc_id, score, now)
            )

    def hotzone_scores(self) -> dict[int, float]:
        rows = self.db.execute("SELECT document_id, score FROM hotzones").fetchall()
        return {r[0]: r[1] for r in rows}

    def stats(self) -> dict:
        n_docs = self.document_count()
        n_content = self.db.execute("SELECT COUNT(*) FROM document_content").fetchone()[0]
        n_pending = self.db.execute(
            "SELECT COUNT(*) FROM embedding_status WHERE status='pending'"
        ).fetchone()[0]
        total_size = self.db.execute(
            "SELECT COALESCE(SUM(file_size),0) FROM documents"
        ).fetchone()[0]
        return {
            "documents": n_docs,
            "extracted": n_content,
            "pending_embeddings": n_pending,
            "logical_bytes": total_size,
        }
