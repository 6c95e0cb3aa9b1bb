"""ContentStore: hash -> chunk -> dedup -> manifest, with a device tier.

Copied from yams_tpu/storage/content_store.py (block engine, WAL,
refcounts, whole-content dedup with self-healing, `_finish_store`,
streaming `store_file`, retrieve, remove, GC) as a class of its own. What
differs is `store_bytes`'s choice of tier: a payload that
`device_pipeline.available` routes to the device runs `device_chunk_hash`
(the gear-hash CDC and SHA-256 kernels) on this store's device; any other
payload runs the host tiers (`_store_host`: the native chunk + hash + zstd
pass when the ingest library built, else the Python chunker and the
policy-compressing engine). Unlike the reference, a device failure is not
swallowed: it propagates.

The store carries the compression monitor, recovery and transaction
managers (`storage/compression_recovery.py`) as the reference's does; the
repair service's `compression` op scans and repairs through them.
"""

from __future__ import annotations

import functools
import pathlib
import threading
import time
import zlib

import torch

from .. import native
from ..core.config import ChunkingConfig, CompressionConfig
from ..core.errors import NotFoundError
from ..core.types import ChunkRef, Manifest, StoreResult
from ..device import resolve_device
from ..ingest.chunker import FastCDCChunker
from ..ingest.compression import ALGO_ZSTD, CompressionHeader, CompressionPolicy
from ..ingest.device_pipeline import available, device_chunk_hash
from ..ingest.hasher import sha256_bytes, sha256_file
from .compression_recovery import (CompressionMonitor,
                                   CompressionRecoveryManager,
                                   CompressionTransactionManager)
from .engine import CompressedStorageEngine, StorageEngine
from .gc import GarbageCollector
from .integrity import IntegrityVerifier
from .progress import ProgressReporter
from .refcounter import ReferenceCounter
from .wal import OP_STORE_BLOCK, WalManager

OP_COMMIT_STORE = "commit_store"
OP_COMMIT_REMOVE = "commit_remove"


def _mutates(fn):
    """Hold the store-level mutation lock for the whole call."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._mutate_lock:
            return fn(self, *args, **kwargs)

    return wrapper


class ContentStore:
    def __init__(
        self,
        root: str | pathlib.Path,
        chunking: ChunkingConfig | None = None,
        compression: CompressionConfig | None = None,
        enable_wal: bool = True,
        *,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.engine = CompressedStorageEngine(
            StorageEngine(self.root), CompressionPolicy(compression)
        )
        self.refcounter = ReferenceCounter(self.root / "storage.db")
        self.chunker = FastCDCChunker(chunking)
        self.wal = WalManager(self.root / "wal") if enable_wal else None
        self.gc = GarbageCollector(self.engine, self.refcounter)
        # Serializes stores against GC: a store may pass engine.exists() for a
        # block whose refcount is 0 and rely on the bytes staying on disk
        # until its _commit lands; GC running in that window would delete the
        # block and leave the new manifest dangling.
        self._mutate_lock = threading.RLock()
        self.verifier = IntegrityVerifier(self.engine, self.refcounter)
        self.compression_monitor = CompressionMonitor()
        self.compression_recovery = CompressionRecoveryManager(
            self.engine.inner, self.refcounter, self.wal,
            self.compression_monitor)
        self.compression_tx = CompressionTransactionManager(
            self.engine.inner, self.wal, self.compression_monitor)
        if self.wal:
            self.recover()

    # -- crash recovery ---------------------------------------------------------
    def recover(self) -> int:
        """Replay WAL commit records newer than the refcounter's watermark
        (block bytes are written before the WAL commit record, so every
        record present can be re-applied; the watermark applies each once)."""
        last = self.refcounter.last_applied_seq()
        applied = 0
        for rec in self.wal.replay():
            seq = rec.get("seq", 0)
            if seq <= last:
                continue
            if rec["op"] == OP_COMMIT_STORE:
                self.refcounter.apply_commit(
                    [(h, s) for h, s in rec["refs"]],
                    Manifest.from_dict(rec["manifest"]),
                    wal_seq=seq,
                )
                applied += 1
            elif rec["op"] == OP_COMMIT_REMOVE:
                self.refcounter.apply_remove(rec["hash"], wal_seq=seq)
                applied += 1
        return applied

    def _commit(self, refs, manifest) -> None:
        """WAL-then-SQLite commit of one store()."""
        if self.wal:
            seq = self.wal.append(
                OP_COMMIT_STORE,
                refs=[(h, s) for h, s in refs],
                manifest=manifest.to_dict(),
            )
            self.wal.sync()
        else:
            seq = None
        self.refcounter.apply_commit(refs, manifest, wal_seq=seq)

    def close(self) -> None:
        if self.wal:
            self.wal.close()
        self.refcounter.close()

    # -- store -------------------------------------------------------------------
    @staticmethod
    def _reporter(progress, total: int):
        """None -> no reporter, a callable -> a fresh ProgressReporter
        wrapping it, a ProgressReporter -> used as-is (total filled in)."""
        if progress is None:
            return None
        if isinstance(progress, ProgressReporter):
            if not progress.progress().total_bytes:
                progress.set_total_bytes(total)
            return progress
        return ProgressReporter(total, callback=progress)

    @_mutates
    def store_bytes(self, data: bytes, mime_type: str = "",
                    progress=None) -> StoreResult:
        t0 = time.monotonic()
        rep = self._reporter(progress, len(data))
        if rep:
            rep.report(0, "hash")
        content_hash = sha256_bytes(data)
        timings = {"hash": (time.monotonic() - t0) * 1e3}
        if self.refcounter.has_manifest(content_hash):
            return self._store_dedup(data, content_hash, timings, t0, rep)
        if available(len(data), self.device):
            return self._store_device(data, content_hash, mime_type, timings, t0, rep)
        return self._store_host(data, content_hash, mime_type, timings, t0, rep)

    def _store_dedup(self, data: bytes, content_hash: str, timings, t0,
                     rep) -> StoreResult:
        """Whole-content dedup: bump manifest + chunk refcounts. A block lost
        to corruption is rewritten from the incoming bytes rather than
        deduped away, so a re-ingest repairs the store."""
        manifest = self.refcounter.get_manifest(content_hash)
        healed_bytes = 0
        for c in manifest.chunks:
            if not self.engine.exists(c.hash):
                self.engine.store(c.hash, data[c.offset:c.offset + c.size])
                healed_bytes += c.size
        self._commit([(c.hash, c.size) for c in manifest.chunks], manifest)
        if rep:
            rep.report(len(data), "dedup")
        return StoreResult(
            content_hash=content_hash,
            bytes_stored=healed_bytes,
            bytes_deduped=len(data) - healed_bytes,
            total_bytes=len(data),
            chunk_count=len(manifest.chunks),
            dedup_ratio=1.0,
            duration_ms=(time.monotonic() - t0) * 1e3,
            phase_timings_ms=timings,
        )

    def _store_blocks(self, items, data: bytes, rep):
        """WAL-log and collect the new blocks of (digest, start, end, blob)
        items, where blob is the block to store (None: the raw bytes)."""
        bytes_stored = bytes_deduped = 0
        refs, chunk_refs, new_blocks = [], [], []
        for digest, start, end, blob in items:
            size = end - start
            refs.append((digest, size))
            chunk_refs.append(ChunkRef(digest, start, size))
            if self.engine.exists(digest):
                bytes_deduped += size
                continue
            if self.wal:
                self.wal.append(OP_STORE_BLOCK, hash=digest, size=size)
            new_blocks.append((digest, data[start:end] if blob is None else blob))
            bytes_stored += size
            if rep:
                rep.report(end, "store")
        return refs, chunk_refs, new_blocks, bytes_stored, bytes_deduped

    def _store_device(self, data: bytes, content_hash: str, mime_type: str,
                      timings, t0, rep) -> StoreResult:
        t = time.monotonic()
        cfg = self.chunker.config
        triples = device_chunk_hash(
            data, cfg.min_size, cfg.avg_size, cfg.max_size, self.device)
        timings["chunk"] = (time.monotonic() - t) * 1e3
        timings["device_tier"] = 1.0
        t = time.monotonic()
        refs, chunk_refs, new_blocks, stored, deduped = self._store_blocks(
            ((h, s, e, None) for h, s, e in triples), data, rep)
        self.engine.store_batch(new_blocks, mime_type)
        timings["store"] = (time.monotonic() - t) * 1e3
        return self._finish_store(
            content_hash, data, refs, chunk_refs, stored, deduped, timings,
            t0, rep)

    def _store_host(self, data: bytes, content_hash: str, mime_type: str,
                    timings, t0, rep) -> StoreResult:
        """The host tiers: one native pass chunks, hashes and compresses with
        zstd when the policy says so and the ingest library built; otherwise
        the Python chunker and the policy-compressing engine."""
        t = time.monotonic()
        cfg = self.chunker.config
        decision = self.engine.policy.decide(cfg.avg_size, mime_type, hot=True)
        pipeline = None
        if decision.compress and decision.algorithm == "zstd":
            pipeline = native.ingest_pipeline(
                data, cfg.min_size, cfg.avg_size, cfg.max_size,
                level=decision.level)
        if pipeline is not None:
            timings["chunk"] = (time.monotonic() - t) * 1e3
            t = time.monotonic()

            def framed(start, end, blob):
                if len(blob) >= end - start:   # incompressible chunk: store raw
                    return None
                return CompressionHeader(
                    algorithm=ALGO_ZSTD, level=decision.level,
                    original_size=end - start, compressed_size=len(blob),
                    crc32=zlib.crc32(blob) & 0xFFFFFFFF).pack() + blob

            refs, chunk_refs, new_blocks, stored, deduped = self._store_blocks(
                ((h, s, e, framed(s, e, b)) for h, s, e, b in pipeline), data, rep)
            self.engine.inner.store_batch(new_blocks)
        else:
            chunks = self.chunker.chunk_bytes(data)
            timings["chunk"] = (time.monotonic() - t) * 1e3
            t = time.monotonic()
            refs, chunk_refs, new_blocks, stored, deduped = self._store_blocks(
                ((c.ref.hash, c.ref.offset, c.ref.offset + c.ref.size, c.data)
                 for c in chunks), data, rep)
            self.engine.store_batch(new_blocks, mime_type)
        timings["store"] = (time.monotonic() - t) * 1e3
        return self._finish_store(
            content_hash, data, refs, chunk_refs, stored, deduped, timings,
            t0, rep)

    def _finish_store(self, content_hash, data, refs, chunk_refs,
                      bytes_stored, bytes_deduped, timings, t0,
                      rep=None) -> StoreResult:
        t = time.monotonic()
        if rep:
            rep.report(len(data), "commit")
        manifest = Manifest(
            content_hash=content_hash,
            total_size=len(data),
            chunks=chunk_refs,
        )
        self._commit(refs, manifest)
        timings["commit"] = (time.monotonic() - t) * 1e3

        return StoreResult(
            content_hash=content_hash,
            bytes_stored=bytes_stored,
            bytes_deduped=bytes_deduped,
            total_bytes=len(data),
            chunk_count=len(chunk_refs),
            dedup_ratio=bytes_deduped / len(data) if data else 0.0,
            duration_ms=(time.monotonic() - t0) * 1e3,
            phase_timings_ms=timings,
        )

    @_mutates
    def store_file(self, path: str | pathlib.Path, mime_type: str = "") -> StoreResult:
        """Streaming store for large files (bounded memory)."""
        path = pathlib.Path(path)
        size = path.stat().st_size
        if size <= 64 * 1024 * 1024:
            return self.store_bytes(path.read_bytes(), mime_type)
        t0 = time.monotonic()
        content_hash = sha256_file(path)
        if self.refcounter.has_manifest(content_hash):
            manifest = self.refcounter.get_manifest(content_hash)
            self._commit([(c.hash, c.size) for c in manifest.chunks], manifest)
            return StoreResult(
                content_hash, 0, size, size, len(manifest.chunks), 1.0,
                (time.monotonic() - t0) * 1e3,
            )
        bytes_stored = bytes_deduped = 0
        refs: list[tuple[str, int]] = []
        chunk_refs: list[ChunkRef] = []
        for ch in self.chunker.chunk_file(path):
            chunk_refs.append(ch.ref)
            refs.append((ch.ref.hash, ch.ref.size))
            if self.engine.exists(ch.ref.hash):
                bytes_deduped += ch.ref.size
            else:
                self.engine.store(ch.ref.hash, ch.data, mime_type)
                bytes_stored += ch.ref.size
        self._commit(
            refs,
            Manifest(content_hash=content_hash, total_size=size, chunks=chunk_refs),
        )
        return StoreResult(
            content_hash, bytes_stored, bytes_deduped, size, len(chunk_refs),
            bytes_deduped / size if size else 0.0, (time.monotonic() - t0) * 1e3,
        )

    # -- retrieve ------------------------------------------------------------------
    def retrieve_bytes(self, content_hash: str, progress=None) -> bytes:
        manifest = self.refcounter.get_manifest(content_hash)
        rep = self._reporter(progress, manifest.total_size)
        parts = []
        for c in manifest.chunks:
            parts.append(self.engine.retrieve(c.hash))
            if rep:
                rep.report(c.offset + c.size, "retrieve")
        data = b"".join(parts)
        if len(data) != manifest.total_size:
            raise NotFoundError(f"content incomplete: {content_hash}")
        return data

    def retrieve_stream(self, content_hash: str):
        manifest = self.refcounter.get_manifest(content_hash)
        for c in manifest.chunks:
            yield self.engine.retrieve(c.hash)

    def exists(self, content_hash: str) -> bool:
        return self.refcounter.has_manifest(content_hash)

    # -- remove ---------------------------------------------------------------------
    @_mutates
    def remove(self, content_hash: str, collect: bool = True) -> bool:
        if not self.refcounter.has_manifest(content_hash):
            return False
        seq = None
        if self.wal:
            seq = self.wal.append(OP_COMMIT_REMOVE, hash=content_hash)
            self.wal.sync()
        removed = self.refcounter.apply_remove(content_hash, wal_seq=seq)
        if removed and collect:
            self.gc.collect()
        return removed

    @_mutates
    def collect(self):
        """GC zero-ref blocks, serialized against concurrent stores."""
        return self.gc.collect()

    def stats(self) -> dict:
        s = self.refcounter.stats()
        s.update(self.engine.stats())
        s["compression"] = self.compression_monitor.snapshot()
        return s
