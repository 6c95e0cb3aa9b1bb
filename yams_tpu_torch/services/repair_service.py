"""RepairService: on-demand repair operations + doctor health checks.

Port of yams_tpu/services/repair_service.py on the port's AppContext: all
15 ops of `OPS` (stuck_documents, orphans, mime, downloads, path_tree,
dedupe, chunks, block_references, graph, fts5, embeddings, topology,
compression, concepts, optimize), `repair_dedupe_apply` and `doctor`.
`dedupe` is a dry-run report (exact + semantic duplicate groups);
`dedupe_apply` deletes non-canonical EXACT duplicates (identical sha256),
keeping the oldest doc. `run()` keeps the reference's per-op
"failed: ..." report.

It departs from the reference in these places only (each pinned by
tests/test_torch_repair.py):

- `doctor`'s device check reads torch on the app's device (the card's
  name on the card), not `jax.devices()`; its native check reads the
  port's own FastCDC/sketch library.
- `repair_embeddings` re-queues only docs marked embedded ("done") that
  have no vector rows. The reference re-queues every doc whose status is
  not 'pending', so a doc with no text ('skipped') is re-queued, and
  reported, on every run.
- `repair_topology` builds as the reference does (a default
  TopologyEngine at epoch 0, on the app's device), then resets the
  engine's route-risk calibration and `topology_persistence` for the new
  construction, as `SearchEngine.rebuild_topology` does. The reference
  sets the topology alone, so shadow evidence gathered on the old
  construction survives a repair and can promote narrow on the new one.
- `repair_orphans` removes only blocks that no live manifest lists. The
  reference removes every block missing from the refcount table, and
  `run()` takes `orphans` before `block_references`: after the refcount
  table is lost, a full repair deletes every block and leaves every
  document unreadable.
"""

from __future__ import annotations

import pathlib
import urllib.parse

import torch


def device_check(device: torch.device) -> tuple[bool, str]:
    """doctor's device line: the card's name on a CUDA device, "cpu" on the
    host. An unusable card is a failed check."""
    if device.type != "cuda":
        return True, "cpu"
    try:
        name = torch.cuda.get_device_name(device)
        torch.empty(1, device=device).add_(1).item()
    except RuntimeError as e:
        return False, f"{device}: {e}"
    return True, f"{device}: {name}"


class RepairService:
    OPS = (
        "stuck_documents", "orphans", "mime", "downloads", "path_tree",
        "dedupe", "chunks", "block_references", "graph", "fts5", "embeddings",
        "topology", "compression", "concepts", "optimize",
    )

    def __init__(self, app):
        self.app = app

    def run(self, ops: list[str] | None = None) -> dict:
        report: dict[str, str] = {}
        for op in ops or self.OPS:
            fn = getattr(self, f"repair_{op}", None)
            if fn is None:
                report[op] = "unknown op"
                continue
            try:
                report[op] = fn()
            except Exception as e:
                report[op] = f"failed: {e}"
        return report

    # -- individual ops ---------------------------------------------------------
    def repair_stuck_documents(self) -> str:
        """Re-extract docs stuck in 'pending' extraction."""
        from ..ingest.detection import detect_mime
        from .extraction import extract_text

        rows = self.app.db.execute(
            "SELECT id, sha256_hash, file_path FROM documents"
            " WHERE extraction_status = 'pending'"
        ).fetchall()
        fixed = 0
        for r in rows:
            try:
                data = self.app.content_store.retrieve_bytes(r["sha256_hash"])
            except Exception:
                continue
            mime = detect_mime(data[:512], r["file_path"])
            got = extract_text(data, mime)
            if got:
                self.app.metadata.set_content(r["id"], got[0], got[1] or r["file_path"])
            else:
                self.app.db.execute(
                    "UPDATE documents SET extraction_status='skipped' WHERE id=?",
                    (r["id"],),
                )
                self.app.db.conn.commit()
            fixed += 1
        return f"{fixed} processed"

    def repair_orphans(self) -> str:
        # a block a live manifest lists is not an orphan, whatever the
        # refcount table says: that table is what block_references rebuilds
        cs = self.app.content_store
        listed = {c.hash for m in cs.refcounter.iter_manifests() for c in m.chunks}
        orphans = [h for h in cs.gc.orphan_scan() if h not in listed]
        for h in orphans:
            self.app.content_store.engine.remove(h)
        stats = self.app.content_store.collect()
        return f"{len(orphans)} orphan blocks removed, {stats.blocks_deleted} GC'd"

    def repair_mime(self) -> str:
        from ..ingest.detection import detect_mime

        rows = self.app.db.execute(
            "SELECT id, sha256_hash, file_path, mime_type FROM documents"
        ).fetchall()
        fixed = 0
        for r in rows:
            try:
                head = next(self.app.content_store.retrieve_stream(r["sha256_hash"]))
            except Exception:
                continue
            mime = detect_mime(head[:512], r["file_path"])
            if mime != r["mime_type"]:
                self.app.db.execute(
                    "UPDATE documents SET mime_type=? WHERE id=?", (mime, r["id"])
                )
                self.app.db.conn.commit()
                fixed += 1
        return f"{fixed} corrected"

    def repair_path_tree(self) -> str:
        with self.app.db.lock, self.app.db.conn:
            self.app.db.conn.execute("DELETE FROM path_tree_nodes")
            rows = self.app.db.conn.execute("SELECT file_path FROM documents").fetchall()
            for (path,) in rows:
                self.app.metadata._upsert_path_tree_tx(path)
        return f"rebuilt from {len(rows)} documents"

    def repair_chunks(self) -> str:
        report = self.app.content_store.verifier.verify_all()
        n = self.app.content_store.verifier.quarantine_corrupted(report)
        return (f"{report.scanned} scanned, {len(report.corrupted)} corrupted"
                f" ({n} quarantined), {len(report.missing)} missing")

    def repair_block_references(self) -> str:
        """Recompute refcounts from manifests (ground truth)."""
        rc = self.app.content_store.refcounter
        want: dict[str, int] = {}
        sizes: dict[str, int] = {}
        for m in rc.iter_manifests():
            for c in m.chunks:
                want[c.hash] = want.get(c.hash, 0) + 1
                sizes[c.hash] = c.size
        fixed = 0
        with rc._lock, rc._conn:
            rc._conn.execute("DELETE FROM block_references")
            import time as _t

            now = _t.time()
            rc._conn.executemany(
                "INSERT INTO block_references VALUES (?,?,?,?,?)",
                [(h, n, sizes[h], now, now) for h, n in want.items()],
            )
            fixed = len(want)
        return f"{fixed} block refcounts rebuilt"

    def repair_graph(self) -> str:
        n = self.app.graph.index_pending()
        return f"{n} documents graphed"

    def repair_fts5(self) -> str:
        rows = self.app.db.execute(
            "SELECT document_id, content_text FROM document_content"
        ).fetchall()
        with self.app.db.lock, self.app.db.conn:
            self.app.db.conn.execute("DELETE FROM documents_fts")
            for r in rows:
                doc = self.app.db.conn.execute(
                    "SELECT file_name FROM documents WHERE id=?", (r["document_id"],)
                ).fetchone()
                self.app.db.conn.execute(
                    "INSERT INTO documents_fts (rowid, title, content) VALUES (?,?,?)",
                    (r["document_id"], doc[0] if doc else "", r["content_text"]),
                )
        return f"{len(rows)} documents re-indexed"

    def repair_embeddings(self) -> str:
        """Embed pending docs; additionally, docs marked embedded but ABSENT
        from the device index (e.g. after a quarantined-corrupt checkpoint,
        app.index_load_event) are reset to pending first so the index is
        rebuilt from metadata, not just topped up."""
        app = self.app
        # "in the index" means the doc's slot has live vector rows — the slot
        # map alone survives in metadata after a quarantined checkpoint, so a
        # fresh process would otherwise see ghosts as covered
        eng = app.search_engine
        rows_by_slot = eng.vector_index._rows_by_slot
        indexed_docs = {
            doc for doc, slot in eng._slot_by_doc.items()
            if rows_by_slot.get(slot)
        }
        missing = [
            int(r[0]) for r in app.db.execute(
                "SELECT document_id FROM embedding_status "
                "WHERE status = 'done'").fetchall()
            if int(r[0]) not in indexed_docs
        ]
        for doc_id in missing:
            app.metadata.set_embedding_status(doc_id, "pending")
        n = app.indexing.reindex_pending()
        extra = f" ({len(missing)} re-queued from lost index)" if missing else ""
        return f"{n} documents embedded{extra}"

    def repair_topology(self) -> str:
        from ..index.topology import TopologyEngine

        se = self.app.search_engine
        vi = se.vector_index
        if vi.active_rows == 0:
            return "no vectors"
        eng = TopologyEngine(device=self.app.device)
        art = eng.build(vi._vecs, vi._valid)
        se.topology = eng
        # a new construction voids the route-risk evidence of the old one
        se._stats["topology_persistence"] = art.centroid_persistence
        se._route_calib = {
            "fingerprint": f"{art.epoch}/{len(art.centroids)}",
            "queries": 0, "protected": 0, "missed": 0,
        }
        return f"{len(art.centroids)} clusters over {vi.active_rows} rows"

    def repair_compression(self) -> str:
        """Scan framed blocks for compression-layer corruption, quarantine
        damaged frames, and repair from the original file when it is still on
        disk (reference: recovery_manager.cpp quarantine + repair flow)."""
        import pathlib as _pl

        from ..ingest.hasher import sha256_bytes

        cs = self.app.content_store
        rep = cs.compression_recovery.scan()
        if not rep.corrupt:
            return f"{rep.scanned} scanned, 0 corrupt"

        # chunk hash -> (content_hash, offset, size) via manifests, resolved
        # lazily to the source document's bytes if its file still exists
        def source_bytes(h: str):
            for m in cs.refcounter.iter_manifests():
                for c in m.chunks:
                    if c.hash != h:
                        continue
                    row = self.app.db.execute(
                        "SELECT file_path FROM documents WHERE sha256_hash=?",
                        (m.content_hash,),
                    ).fetchone()
                    if not row:
                        continue
                    p = _pl.Path(row[0])
                    if not p.is_file():
                        continue
                    data = p.read_bytes()
                    if sha256_bytes(data) != m.content_hash:
                        continue  # file changed since ingest
                    return data[c.offset:c.offset + c.size]
            return None

        out = cs.compression_recovery.repair(
            rep.corrupt_hashes, source_bytes=source_bytes)
        return (f"{rep.scanned} scanned, {len(rep.corrupt)} corrupt, "
                f"{out.quarantined} quarantined, {len(out.repaired)} "
                f"repaired, {len(out.unrepairable)} unrepairable")

    def repair_concepts(self) -> str:
        """PMI bigram-concept mining -> KG (reference:
        simeon_lexical_backend.h:140-150 concept mining + entity callback):
        high-PMI adjacent word pairs become `concept:` nodes aliased by
        their surface phrase and linked to every doc containing them, so
        the host KG leg scores query concepts against documents.
        Idempotent: each concept's doc links are replaced, not appended."""
        eng = self.app.search_engine
        concepts = eng.lexical_index.mine_concepts()
        if not concepts:
            return "0 concepts"
        kg = self.app.kg
        doc_by_slot = eng._doc_by_slot
        linked = 0
        for a, b, pmi, df in concepts:
            phrase = f"{a} {b}"
            nid = kg.upsert_node(
                f"concept:{phrase}", label=phrase, type_="concept",
                properties={"pmi": round(pmi, 3), "df": df})
            if nid not in kg.resolve_alias(phrase, limit=10):
                kg.add_alias(nid, phrase, source="pmi")
            conf = min(1.0, pmi / 8.0)
            with self.app.db.lock, self.app.db.conn:
                self.app.db.conn.execute(
                    "DELETE FROM doc_entities WHERE node_id=?", (nid,))
            for slot in eng.lexical_index.docs_with_bigram(a, b):
                if slot < len(doc_by_slot) and doc_by_slot[slot] >= 0:
                    kg.link_document(doc_by_slot[slot], nid, phrase, conf)
                    linked += 1
        return f"{len(concepts)} concepts, {linked} doc links"

    def repair_optimize(self) -> str:
        self.app.db.vacuum()
        self.app.checkpoint()
        return "vacuumed + checkpointed"

    def repair_downloads(self) -> str:
        """Normalize downloaded documents + clean stale download state.

        Reference behavior (RepairService.cpp:1858-1955): documents whose
        file_path is a raw URL get the path rewritten to the URL's filename,
        `source_url` metadata, and `downloaded`/`host:`/`scheme:` tags. On
        top of that we garbage-collect .part files with no resume-store entry
        and resume entries with no .part file.
        """
        app = self.app
        fixed = 0
        rows = app.db.execute(
            "SELECT id, file_path FROM documents WHERE file_path LIKE '%://%'"
        ).fetchall()
        for doc_id, url in rows:
            # ingest normalizes names to rooted paths: "/https://host/x"
            url = url.lstrip("/") if "://" in url else url
            parsed = urllib.parse.urlparse(url)
            name = parsed.path.rsplit("/", 1)[-1] or "downloaded_file"
            ext = ("." + name.rsplit(".", 1)[-1]) if "." in name else ""
            try:
                with app.db.lock, app.db.conn:
                    app.db.conn.execute(
                        "UPDATE documents SET file_path=?, file_name=?, "
                        "file_extension=? WHERE id=?",
                        (name, name, ext, doc_id),
                    )
            except Exception:
                # file_path is unique — on collision keep the URL path but
                # still record source_url + tags below
                pass
            app.metadata.set_metadata(doc_id, "source_url", url)
            tags = set(app.metadata.get_tags(doc_id)) | {"downloaded"}
            if parsed.netloc:
                tags.add(f"host:{parsed.netloc}")
            if parsed.scheme:
                tags.add(f"scheme:{parsed.scheme}")
            app.metadata.set_tags(doc_id, sorted(tags))
            fixed += 1

        # stale .part / resume entries — under the store lock so concurrent
        # job threads can't register a partial between our read and unlink
        dl = app.downloads
        with dl._resume_lock:
            state = dl._load_resume()
            live_parts = {v.get("part") for v in state.values()
                          if isinstance(v, dict)}
            orphan_parts = 0
            for p in dl.dir.glob("*.part"):
                if str(p) not in live_parts:
                    p.unlink(missing_ok=True)
                    orphan_parts += 1
            stale_entries = [u for u, v in state.items()
                             if not (isinstance(v, dict)
                                     and pathlib.Path(v.get("part", "")).exists())]
            for u in stale_entries:
                state.pop(u, None)
            if stale_entries:
                dl._save_resume(state)
        return (f"{fixed} url-docs normalized, {orphan_parts} orphan .part "
                f"removed, {len(stale_entries)} stale resume entries cleared")

    def _duplicate_groups(self) -> tuple[list[list[int]], list[dict]]:
        """(exact sha256 groups as sorted doc-id lists, semantic pair report)."""
        rows = self.app.db.execute(
            "SELECT sha256_hash, GROUP_CONCAT(id) FROM documents "
            "GROUP BY sha256_hash HAVING COUNT(*) > 1"
        ).fetchall()
        exact = [sorted(int(i) for i in ids.split(",")) for _, ids in rows]
        try:
            semantic = self.app.search.semantic_dedupe(limit_docs=500)
        except Exception:
            semantic = []
        return exact, semantic

    def repair_dedupe(self) -> str:
        """Dry-run duplicate report (the safe default in `repair` runs)."""
        exact, semantic = self._duplicate_groups()
        redundant = sum(len(g) - 1 for g in exact)
        return (f"{len(exact)} exact-duplicate groups ({redundant} redundant "
                f"docs; run dedupe_apply to delete), "
                f"{len(semantic)} semantic near-duplicate pairs (report-only)")

    def repair_dedupe_apply(self) -> str:
        """Delete non-canonical EXACT duplicates (lowest doc id is canonical,
        mirroring the reference's canonical-member deletion)."""
        exact, _ = self._duplicate_groups()
        deleted = 0
        for group in exact:
            canonical, *rest = group
            for doc_id in rest:
                try:
                    doc = self.app.metadata.get_document(doc_id)
                    if self.app.documents.delete(doc.file_path, keep_content=True):
                        deleted += 1
                except Exception:
                    pass
        return f"{deleted} redundant exact-duplicate docs deleted"

    # -- doctor -------------------------------------------------------------------
    def doctor(self) -> dict[str, tuple[bool, str]]:
        app = self.app
        checks: dict[str, tuple[bool, str]] = {}
        checks["metadata_db"] = (
            app.db.integrity_check(), str(app.config.metadata_db)
        )
        storage_ok = pathlib.Path(app.config.storage_dir).is_dir()
        checks["storage_dir"] = (storage_ok, str(app.config.storage_dir))
        n_docs = app.metadata.document_count()
        n_indexed = app.search_engine.stats()["documents"]
        checks["index_coverage"] = (
            True, f"{n_indexed}/{n_docs} documents in device index"
        )
        from .. import native

        checks["native_lib"] = (
            native.sketch_library() is not None,
            "C++ fastcdc/sketch library",
        )
        checks["device"] = device_check(app.device)
        pending = len(app.metadata.docs_pending_embedding())
        checks["embeddings"] = (pending == 0, f"{pending} pending")
        ev = getattr(app, "index_load_event", None)
        checks["index_checkpoint"] = (
            ev is None,
            "loaded" if ev is None else
            f"rebuild required: {ev['error']} "
            f"(quarantined {', '.join(ev['quarantined']) or 'nothing'})",
        )
        report = app.content_store.verifier.verify_all(limit=64)
        checks["block_integrity"] = (
            not report.corrupted and not report.missing,
            f"{report.ok}/{report.scanned} ok",
        )
        return checks
