"""ContentStore whose large stores chunk and hash on the port's device tier.

Port of the device branch of yams_tpu/storage/content_store.py
(`ContentStore.store_bytes`). Everything else — whole-content dedup, the
block engine, WAL, refcounts, `_finish_store` — is the reference's own code,
inherited. Payloads that `device_pipeline.available` routes to the device
run `device_chunk_hash` on this store's device; any other payload goes to the
parent's host tiers. The parent's own (JAX) device tier is switched off for
those: it is told there is no backend, so it neither imports jax nor runs its
device path with a fall-back on any error.

Unlike the reference, a device failure is not swallowed: it propagates.

The yams_tpu storage package needs msgpack and zstandard, so this module is
imported on its own (it is not pulled in by `yams_tpu_torch/__init__.py`).
"""

from __future__ import annotations

import pathlib
import time

import torch

import yams_tpu.ingest.device_pipeline as _reference_tier
from yams_tpu.core.types import ChunkRef, StoreResult
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
        if not available(len(data), self.device):
            _reference_tier._backend_cache = "none"   # parent: host tiers only
            return super().store_bytes(data, mime_type, progress)
        with self._mutate_lock:
            content_hash = sha256_bytes(data)
            if self.refcounter.has_manifest(content_hash):
                # whole-content dedup: the parent's path, which never chunks
                return super().store_bytes(data, mime_type, progress)
            return self._store_device(data, content_hash, mime_type, progress)

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
        bytes_stored = bytes_deduped = 0
        refs, chunk_refs, new_blocks = [], [], []
        for digest, start, end in triples:
            size = end - start
            refs.append((digest, size))
            chunk_refs.append(ChunkRef(digest, start, size))
            if self.engine.exists(digest):
                bytes_deduped += size
                continue
            if self.wal:
                self.wal.append(OP_STORE_BLOCK, hash=digest, size=size)
            new_blocks.append((digest, data[start:end]))
            bytes_stored += size
            if rep:
                rep.report(end, "store")
        self.engine.store_batch(new_blocks, mime_type)
        timings["store"] = (time.monotonic() - t) * 1e3
        return self._finish_store(
            content_hash, data, refs, chunk_refs, bytes_stored,
            bytes_deduped, timings, t0, rep)
