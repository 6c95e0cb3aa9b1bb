"""IndexingService: directory walking + batch add + tree snapshots.

Parity: src/app/services/indexing_service.cpp + document_ingestion_service.cpp
(include/exclude globs, recursive walk, hash-verify) and the tree-snapshot
flow (TreeBuilder over the ingested set).

Copied from yams_tpu/services/indexing_service.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import pathlib

from ..metadata.tree import TreeEntry

# docs per batched engine index call: bounds host memory for chunk texts
# while keeping the encode matmul MXU-sized
INDEX_BATCH_DOCS = 64


@dataclasses.dataclass(slots=True)
class IndexReport:
    files_added: int = 0
    files_skipped: int = 0
    files_failed: int = 0
    bytes_stored: int = 0
    bytes_deduped: int = 0
    snapshot_id: str = ""
    errors: list[str] = dataclasses.field(default_factory=list)


DEFAULT_EXCLUDES = (
    "*/.git/*", "*/__pycache__/*", "*.pyc", "*/node_modules/*", "*/.venv/*",
    "*/.pytest_cache/*", "*.o", "*.so", "*.a",
)


class IndexingService:
    def __init__(self, app):
        self.app = app

    def add_directory(
        self,
        directory: str | pathlib.Path,
        recursive: bool = True,
        include: list[str] | None = None,
        exclude: list[str] | None = None,
        tags: list[str] | None = None,
        collection: str = "",
        max_file_bytes: int = 64 * 1024 * 1024,
        snapshot: bool = False,
        snapshot_label: str = "",
    ) -> IndexReport:
        root = pathlib.Path(directory).resolve()
        report = IndexReport()
        pending_index: list[int] = []
        excludes = list(exclude or []) + list(DEFAULT_EXCLUDES)
        walker = root.rglob("*") if recursive else root.glob("*")
        entries: list[TreeEntry] = []
        for p in sorted(walker):
            if not p.is_file():
                continue
            rel = str(p)
            if include and not any(
                fnmatch.fnmatch(rel, g) or fnmatch.fnmatch(p.name, g) for g in include
            ):
                report.files_skipped += 1
                continue
            if any(fnmatch.fnmatch(rel, g) or fnmatch.fnmatch(p.name, g)
                   for g in excludes):
                report.files_skipped += 1
                continue
            try:
                if p.stat().st_size > max_file_bytes:
                    report.files_skipped += 1
                    continue
                # store + extract now, index in batches below: one big
                # encode feeds the MXU far better than a tiny matmul (and a
                # device round trip) per file
                res = self.app.documents.add_file(
                    p, tags=tags, collection=collection, auto_index=False
                )
                report.files_added += 1
                report.bytes_stored += res.bytes_stored
                report.bytes_deduped += res.bytes_deduped
                pending_index.append(res.document_id)
                if len(pending_index) >= INDEX_BATCH_DOCS:
                    self._index_docs_batch(pending_index)
                    pending_index.clear()
                entries.append(
                    TreeEntry(str(p), res.content_hash, size=p.stat().st_size)
                )
            except Exception as e:  # keep walking; record the failure
                report.files_failed += 1
                report.errors.append(f"{p}: {e}")
        if pending_index:
            self._index_docs_batch(pending_index)
        if snapshot and entries:
            report.snapshot_id = self.app.trees.snapshot(
                entries, label=snapshot_label or str(root)
            )
        return report

    def restore_snapshot(
        self,
        snapshot_id: str,
        target_dir: str | pathlib.Path,
        overwrite: bool = False,
        dry_run: bool = False,
    ) -> dict:
        """Materialize a tree snapshot's files from the CAS
        (reference: restore_command.cpp). dry_run counts without writing."""
        target = pathlib.Path(target_dir)
        if not dry_run:
            target.mkdir(parents=True, exist_ok=True)
        entries = self.app.trees.get_snapshot(snapshot_id)
        restored = skipped = failed = 0
        for e in entries:
            if e.is_dir:
                continue
            rel = e.path.lstrip("/")
            # snapshot paths are absolute source paths: re-root under target
            out = target / pathlib.PurePath(rel).name if "/" not in rel else \
                target / pathlib.PurePath(*pathlib.PurePath(rel).parts[-2:])
            if out.exists() and not overwrite:
                skipped += 1
                continue
            try:
                if dry_run:
                    if not self.app.content_store.exists(e.hash):
                        raise FileNotFoundError(e.hash)
                else:
                    data = self.app.content_store.retrieve_bytes(e.hash)
                    out.parent.mkdir(parents=True, exist_ok=True)
                    out.write_bytes(data)
                restored += 1
            except Exception:
                failed += 1
        return {"restored": restored, "skipped": skipped, "failed": failed,
                "target": str(target), "dry_run": dry_run}

    def restore_collection(
        self,
        collection: str,
        target_dir: str | pathlib.Path,
        overwrite: bool = False,
        dry_run: bool = False,
    ) -> dict:
        """Materialize every document of a collection from the CAS
        (reference: RestoreCollectionRequest, ipc_protocol_requests.h:1985).
        dry_run counts without writing."""
        target = pathlib.Path(target_dir)
        if not dry_run:
            target.mkdir(parents=True, exist_ok=True)
        doc_ids = self.app.metadata.find_by_metadata("collection", collection)
        restored = skipped = failed = 0
        for doc_id in doc_ids:
            try:
                doc = self.app.metadata.get_document(doc_id)
                # re-root the full stored path: basenames alone collide
                # (/a/config.json vs /b/config.json would clobber or skip)
                rel = pathlib.PurePath(doc.file_path.lstrip("/"))
                out = target / rel
                if out.exists() and not overwrite:
                    skipped += 1
                    continue
                if dry_run:
                    if not self.app.content_store.exists(doc.sha256_hash):
                        raise FileNotFoundError(doc.sha256_hash)
                else:
                    out.parent.mkdir(parents=True, exist_ok=True)
                    out.write_bytes(self.app.documents.cat(doc.file_path))
                restored += 1
            except Exception:
                failed += 1
        return {"restored": restored, "skipped": skipped, "failed": failed,
                "collection": collection, "target": str(target),
                "dry_run": dry_run}

    def _index_docs_batch(self, doc_ids: list[int]) -> int:
        """Index stored-but-unindexed docs through the engine's batched path
        (one encode for the whole group) + per-doc symbol stage."""
        items: list[tuple[int, str, str]] = []
        mimes: dict[int, str] = {}
        for doc_id in doc_ids:
            text = self.app.metadata.get_content(doc_id)
            if text is None:
                self.app.metadata.set_embedding_status(doc_id, "skipped")
                continue
            doc = self.app.metadata.get_document(doc_id)
            items.append((doc_id, text, doc.file_name))
            mimes[doc_id] = doc.mime_type
        if not items:
            return 0
        self.app.search_engine.add_documents(items)
        for doc_id, text, _title in items:
            slot = self.app.search_engine._slot_by_doc[doc_id]
            self.app.metadata.set_metadata(doc_id, "__slot__", str(slot))
            self.app.metadata.set_embedding_status(
                doc_id, "done", self.app.config.embedding.profile
            )
            self.app.symbols.index_document(doc_id, text, mimes[doc_id])
        return len(items)

    def reindex_pending(self, limit: int = 1000) -> int:
        """Embed/index docs whose embedding_status is pending (repair path).
        Batched: one device encode per INDEX_BATCH_DOCS group."""
        pending = self.app.metadata.docs_pending_embedding(limit)
        done = 0
        for i in range(0, len(pending), INDEX_BATCH_DOCS):
            done += self._index_docs_batch(pending[i:i + INDEX_BATCH_DOCS])
        return done
