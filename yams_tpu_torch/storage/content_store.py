"""ContentStore whose large stores chunk and hash on the port's device tier.

Port of yams_tpu/storage/content_store.py `ContentStore.store_bytes`. The
block engine, WAL, refcounts, whole-content dedup and `_finish_store` are the
reference's own code, inherited. Payloads that `device_pipeline.available`
routes to the device run `device_chunk_hash` on this store's device; any
other payload runs the parent's host tiers (`_store_host`: the native
chunk + hash + zstd pass, else the Python chunker). The parent's
`store_bytes` is reached only for whole-content dedup, which returns before
its device check: that check would import jax and run the reference's own
device tier. No module state of yams_tpu is touched.

Unlike the reference, a device failure is not swallowed: it propagates.

The yams_tpu storage package needs msgpack and zstandard, so this module is
imported on its own (it is not pulled in by `yams_tpu_torch/__init__.py`).
"""

from __future__ import annotations

import pathlib
import time
import zlib

import torch

from yams_tpu import native as _native
from yams_tpu.core.types import ChunkRef, StoreResult
from yams_tpu.ingest.compression import ALGO_ZSTD, CompressionHeader
from yams_tpu.ingest.hasher import sha256_bytes
from yams_tpu.storage.content_store import ContentStore as _ReferenceStore
from yams_tpu.storage.wal import OP_STORE_BLOCK

from ..device import resolve_device
from ..ingest.device_pipeline import available, device_chunk_hash


class ContentStore(_ReferenceStore):
    def __init__(self, root: str | pathlib.Path, chunking=None,
                 compression=None, enable_wal: bool = True, *,
                 device: str | torch.device):
        super().__init__(root, chunking=chunking, compression=compression,
                         enable_wal=enable_wal)
        self.device = resolve_device(device)

    def store_bytes(self, data: bytes, mime_type: str = "",
                    progress=None) -> StoreResult:
        with self._mutate_lock:
            t0 = time.monotonic()
            content_hash = sha256_bytes(data)
            hash_ms = (time.monotonic() - t0) * 1e3
            if self.refcounter.has_manifest(content_hash):
                # whole-content dedup: the parent's path, which never chunks
                return super().store_bytes(data, mime_type, progress)
            if available(len(data), self.device):
                return self._store_device(data, content_hash, mime_type, progress)
            return self._store_host(data, content_hash, mime_type, progress,
                                    t0, hash_ms)

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
                      progress) -> StoreResult:
        t0 = time.monotonic()
        rep = self._reporter(progress, len(data))
        if rep:
            rep.report(0, "hash")
        timings: dict[str, float] = {}
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
                    progress, t0: float, hash_ms: float) -> StoreResult:
        """The reference's host tiers (content_store.py:183-298): one native
        pass chunks, hashes and compresses with zstd when the policy says
        so; otherwise the Python chunker and the policy-compressing engine."""
        rep = self._reporter(progress, len(data))
        if rep:
            rep.report(0, "hash")
        timings = {"hash": hash_ms}
        t = time.monotonic()
        cfg = self.chunker.config
        decision = self.engine.policy.decide(cfg.avg_size, mime_type, hot=True)
        pipeline = None
        if decision.compress and decision.algorithm == "zstd":
            pipeline = _native.ingest_pipeline(
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
