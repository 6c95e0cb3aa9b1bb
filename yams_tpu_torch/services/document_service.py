"""DocumentService: add/get/cat/delete/update/list.

Parity: src/app/services/document_service.cpp. add() runs the full ingest
pipeline synchronously: CAS store -> metadata tx -> extraction -> device index
(lexical + vectors) — the reference's PostIngestQueue stages collapsed into a
direct call path; the daemon wraps this in its async queue.

Copied from yams_tpu/services/document_service.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

from ..core.errors import InvalidArgumentError, NotFoundError
from ..core.types import DocumentInfo, StoreResult
from ..ingest.detection import detect_mime
from .extraction import extract_text


@dataclasses.dataclass(slots=True)
class AddResult:
    document_id: int
    content_hash: str
    bytes_stored: int
    bytes_deduped: int
    indexed: bool
    chunks: int
    duration_ms: float


class DocumentService:
    def __init__(self, app):
        self.app = app

    # -- add -------------------------------------------------------------------
    def add_bytes(
        self,
        data: bytes,
        name: str,
        tags: list[str] | None = None,
        metadata: dict[str, str] | None = None,
        mime_type: str = "",
        collection: str = "",
        auto_index: bool = True,
        expand_archives: bool = True,
    ) -> AddResult:
        t0 = time.monotonic()
        mime = mime_type or detect_mime(data[:512], name)
        store_res: StoreResult = self.app.content_store.store_bytes(data, mime)
        path = name if name.startswith("/") else f"/{name}"
        info = DocumentInfo(
            file_path=path,
            file_name=pathlib.PurePath(path).name,
            file_extension=pathlib.PurePath(path).suffix,
            file_size=len(data),
            sha256_hash=store_res.content_hash,
            mime_type=mime,
            tags=list(tags or []),
            metadata=dict(metadata or {}),
        )
        if collection:
            info.metadata["collection"] = collection

        # typed content handlers: image/audio/video header metadata
        # (reference: src/content/ handler registry)
        from ..ingest.content_handlers import (
            extract_typed_metadata, is_archive_mime, iter_archive_members,
        )

        info.metadata.update(extract_typed_metadata(data, mime))

        extracted = extract_text(data, mime)
        text, title = extracted if extracted else (None, "")
        title = title or info.file_name
        doc_id = self.app.metadata.insert_document(info, content_text=text, title=title)

        indexed, chunks = False, 0
        if auto_index and text is not None:
            chunks = self.app.search_engine.add_document(doc_id, text, title)
            slot = self.app.search_engine._slot_by_doc[doc_id]
            self.app.metadata.set_metadata(doc_id, "__slot__", str(slot))
            self.app.metadata.set_embedding_status(
                doc_id, "done", self.app.config.embedding.profile
            )
            # symbol stage (reference: PostIngestQueue Symbol stage)
            self.app.symbols.index_document(doc_id, text, mime)
            indexed = True
        elif text is None:
            self.app.metadata.set_embedding_status(doc_id, "skipped")

        # archive expansion: zip/tar members become child documents, indexed
        # searchably with parent linkage (reference:
        # archive_content_handler.cpp extractFileList -> entries). One level
        # deep — members that are themselves archives are stored unexpanded.
        if expand_archives and is_archive_mime(mime):
            n_members = 0
            for member, payload in iter_archive_members(data, mime, name):
                try:
                    self.add_bytes(
                        payload, f"{path.lstrip('/')}!/{member}",
                        tags=tags,
                        metadata={**dict(metadata or {}),
                                  "archive_parent": path,
                                  "archive_member": member},
                        collection=collection,
                        auto_index=auto_index,
                        expand_archives=False,
                    )
                    n_members += 1
                except Exception:
                    pass  # one bad member must not fail the archive add
            if n_members:
                self.app.metadata.set_metadata(
                    doc_id, "archive_members", str(n_members))

        return AddResult(
            document_id=doc_id,
            content_hash=store_res.content_hash,
            bytes_stored=store_res.bytes_stored,
            bytes_deduped=store_res.bytes_deduped,
            indexed=indexed,
            chunks=chunks,
            duration_ms=(time.monotonic() - t0) * 1e3,
        )

    def add_file(self, path: str | pathlib.Path, **kw) -> AddResult:
        p = pathlib.Path(path)
        if not p.is_file():
            raise InvalidArgumentError(f"not a file: {path}")
        kw.setdefault("name", str(p.resolve()))
        return self.add_bytes(p.read_bytes(), **kw)

    # -- get --------------------------------------------------------------------
    def _resolve(self, selector: str) -> DocumentInfo:
        """Resolve by hash (full/prefix), exact path, or name."""
        md = self.app.metadata
        if len(selector) == 64 and all(c in "0123456789abcdef" for c in selector):
            docs = md.get_by_hash(selector)
            if docs:
                return md.get_document(docs[0].id)
        doc = md.get_by_path(selector if selector.startswith("/") else f"/{selector}")
        if doc:
            return md.get_document(doc.id)
        docs = md.find_by_name(selector)
        if docs:
            return md.get_document(docs[0].id)
        if len(selector) >= 8 and all(c in "0123456789abcdef" for c in selector):
            rows = self.app.db.execute(
                "SELECT * FROM documents WHERE sha256_hash LIKE ? LIMIT 2",
                (selector + "%",),
            ).fetchall()
            if len(rows) == 1:
                return md.get_document(rows[0]["id"])
            if len(rows) > 1:
                raise InvalidArgumentError(f"ambiguous hash prefix: {selector}")
        raise NotFoundError(f"document not found: {selector}")

    def get(self, selector: str) -> DocumentInfo:
        return self._resolve(selector)

    def cat(self, selector: str) -> bytes:
        doc = self._resolve(selector)
        return self.app.content_store.retrieve_bytes(doc.sha256_hash)

    def get_text(self, selector: str) -> str:
        doc = self._resolve(selector)
        text = self.app.metadata.get_content(doc.id)
        if text is None:
            raise NotFoundError(f"no extracted text for: {selector}")
        return text

    def list(self, limit: int = 100, offset: int = 0,
             pattern: str | None = None, tags: list[str] | None = None,
             collection: str | None = None, filters: dict | None = None,
             sort: str | None = None, reverse: bool = False,
             with_tags: bool = False):
        """List documents with the shared filter surface (reference
        list_command: tags, type/mime classes, time bounds, sort orders)."""
        if tags or collection or filters:
            from .filters import resolve_filter_ids

            ids = resolve_filter_ids(self.app, tags, None, collection, filters)
            # fetch the full window: matches may be arbitrarily old, so a
            # newest-first prefix of limit+offset rows can miss all of them
            docs = self.app.metadata.list_documents(1 << 30, 0, pattern)
            if ids is not None:
                docs = [d for d in docs if d.id in ids]
        else:
            if sort is None:
                docs = self.app.metadata.list_documents(limit, offset, pattern)
                if with_tags:
                    for d in docs:
                        d.tags = self.app.metadata.get_tags(d.id)
                return docs
            docs = self.app.metadata.list_documents(1 << 30, 0, pattern)
        keys = {
            "name": lambda d: d.file_path,
            "size": lambda d: d.file_size,
            "date": lambda d: d.modified_time,
            "indexed": lambda d: d.indexed_time,
            "hash": lambda d: d.sha256_hash,
        }
        if sort in keys:
            docs = sorted(docs, key=keys[sort], reverse=reverse)
        elif reverse:
            docs = list(reversed(docs))
        docs = docs[offset:offset + limit]
        if with_tags:
            for d in docs:
                d.tags = self.app.metadata.get_tags(d.id)
        return docs

    # -- delete ------------------------------------------------------------------
    def delete(self, selector: str, keep_content: bool = False) -> bool:
        try:
            doc = self._resolve(selector)
        except NotFoundError:
            return False
        self.app.search_engine.remove_document(doc.id)
        self.app.metadata.delete_document(doc.id)
        if not keep_content:
            self.app.content_store.remove(doc.sha256_hash)
        return True

    def prune(self, older_than_s: float | None = None,
              pattern: str | None = None, tags: list[str] | None = None,
              dry_run: bool = True, report_limit: int = 200) -> dict:
        """Delete documents matching age/pattern/tag filters; dry-run by
        default (reference: PruneRequest, ipc_protocol_requests.h:1904).
        Single implementation shared by the daemon handler and MCP tool."""
        import fnmatch
        import time as _time

        cutoff = _time.time() - older_than_s if older_than_s else None
        tag_ids = set(self.app.metadata.find_by_tags(tags)) if tags else None
        victims = []
        for d in self.app.metadata.list_documents(limit=1 << 30):
            if cutoff is not None and d.created_time > cutoff:
                continue
            if pattern and not fnmatch.fnmatch(d.file_path, pattern):
                continue
            if tag_ids is not None and d.id not in tag_ids:
                continue
            victims.append({"id": d.id, "path": d.file_path})
        if not dry_run:
            for v in victims:
                try:
                    self.delete(v["path"])
                except Exception:
                    v["error"] = "delete failed"
        return {"matched": len(victims), "dry_run": dry_run,
                "documents": victims[:report_limit]}

    def file_history(self, path: str, limit: int = 50) -> dict:
        """Appearances of a path across tree snapshots, newest first."""
        rows = self.app.db.execute(
            """SELECT e.snapshot_id, e.hash, e.size, s.created_time, s.label
               FROM tree_snapshot_entries e
               JOIN tree_snapshots s ON s.snapshot_id = e.snapshot_id
               WHERE e.path = ? OR e.path LIKE ?
               ORDER BY s.created_time DESC LIMIT ?""",
            (path, f"%/{path.lstrip('/')}", limit),
        ).fetchall()
        return {"versions": [
            {"snapshot_id": r[0], "hash": r[1], "size": r[2],
             "created_time": r[3], "label": r[4]} for r in rows]}

    # -- update ------------------------------------------------------------------
    def update_metadata(
        self, selector: str, metadata: dict[str, str] | None = None,
        add_tags: list[str] | None = None, remove_tags: list[str] | None = None,
    ) -> DocumentInfo:
        doc = self._resolve(selector)
        for k, v in (metadata or {}).items():
            self.app.metadata.set_metadata(doc.id, k, v)
        if add_tags or remove_tags:
            tags = set(self.app.metadata.get_tags(doc.id))
            tags |= set(add_tags or [])
            tags -= set(remove_tags or [])
            self.app.metadata.set_tags(doc.id, sorted(tags))
        return self.app.metadata.get_document(doc.id)
