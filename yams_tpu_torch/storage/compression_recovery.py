"""Compression error recovery, transactional recompression, and monitoring.

Parity with the reference's compression subsystem beyond the codec itself:
  - RecoveryManager (src/compression/recovery_manager.cpp): scan framed
    blocks for corruption (bad header / CRC / codec failure / content-hash
    mismatch), quarantine the damaged frame instead of silently serving or
    deleting it, and repair from the best available source (object-storage
    replica, then the original file still on disk).
  - TransactionManager (src/compression/transaction_manager.cpp):
    journaled batch recompression when the policy changes (e.g. hot zstd-1
    blocks aging into archival LZMA) — crash mid-batch resumes from the WAL
    journal, and every individual block swap is atomic (temp+fsync+rename in
    StorageEngine.store), so a half-done batch never loses data.
  - CompressionMonitor (src/compression/compression_monitor.cpp): running
    counters of scans, corruption classes, repairs, and per-algorithm
    compression ratios for the stats/doctor surface.

Quarantined frames move to <root>/quarantine/<hash>.<n> — kept for forensics
(the reference's recovery manager likewise retains damaged frames), while the
CAS slot is freed so self-healing dedup (ContentStore.store_bytes) or an
explicit repair can rewrite clean bytes.

Copied from yams_tpu/storage/compression_recovery.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading
import time
import zlib

from ..core.errors import CorruptionError
from ..ingest.compression import (
    HEADER_SIZE,
    CompressionHeader,
    CompressionRegistry,
    compress_block,
    is_compressed_block,
)
from ..ingest.hasher import sha256_bytes
from .wal import WalManager

OP_QUARANTINE = "compression_quarantine"
OP_RECOMPRESS_BEGIN = "recompress_begin"
OP_RECOMPRESS_COMMIT = "recompress_commit"


@dataclasses.dataclass(slots=True)
class CompressionScanReport:
    scanned: int = 0
    ok: int = 0
    raw: int = 0                    # unframed (stored uncompressed)
    corrupt: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    duration_ms: float = 0.0

    @property
    def corrupt_hashes(self) -> list[str]:
        return [h for h, _ in self.corrupt]


@dataclasses.dataclass(slots=True)
class RepairReport:
    quarantined: int = 0
    repaired: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    unrepairable: list[str] = dataclasses.field(default_factory=list)


class CompressionRecoveryManager:
    """Detect + quarantine + repair corrupt compressed frames.

    Operates on the RAW engine (below the transparent-decompression
    decorator) so it can distinguish frame damage from plain bit rot:
    a frame whose CRC fails is a compression-layer fault even when the
    decompressed content hash could never be checked.
    """

    def __init__(self, raw_engine, refcounter, wal: WalManager | None = None,
                 monitor: "CompressionMonitor | None" = None):
        self.engine = raw_engine          # StorageEngine (no decompression)
        self.refcounter = refcounter
        self.wal = wal
        self.monitor = monitor or CompressionMonitor()
        self.quarantine_dir = pathlib.Path(raw_engine.root) / "quarantine"

    # -- detection -------------------------------------------------------------
    def classify_block(self, h: str) -> tuple[str, str]:
        """(state, detail): state in ok|raw|missing|corrupt."""
        if not self.engine.exists(h):
            return "missing", ""
        try:
            blob = self.engine.retrieve(h)
        except Exception as e:  # unreadable file
            return "corrupt", f"unreadable: {e}"
        # ground truth first: if the raw bytes hash to h this is a healthy
        # uncompressed block, no matter what it happens to look like
        if sha256_bytes(blob) == h:
            return "raw", ""
        # otherwise it must be a valid frame; classify the damage. NOTE:
        # is_compressed_block() can't gate here — it includes the CRC check,
        # which would misroute a CRC-corrupt FRAME into the raw branch.
        try:
            header = CompressionHeader.unpack(blob)
        except CorruptionError as e:
            return "corrupt", f"header: {e}"
        if header.algorithm not in CompressionRegistry._by_id:
            return "corrupt", f"header: unknown algorithm {header.algorithm}"
        if len(blob) != HEADER_SIZE + header.compressed_size:
            return "corrupt", "frame length mismatch"
        payload = blob[HEADER_SIZE:]
        if zlib.crc32(payload) & 0xFFFFFFFF != header.crc32:
            return "corrupt", "payload CRC mismatch"
        try:
            out = CompressionRegistry.get(header.algorithm).decompress(
                payload, header.original_size)
        except Exception as e:
            return "corrupt", f"decode: {e}"
        if len(out) != header.original_size:
            return "corrupt", "decompressed size mismatch"
        if sha256_bytes(out) != h:
            return "corrupt", "content-hash mismatch after decompress"
        return "ok", ""

    def scan(self, limit: int | None = None) -> CompressionScanReport:
        t0 = time.monotonic()
        rep = CompressionScanReport()
        for h in sorted(self.refcounter.known_blocks()):
            if limit is not None and rep.scanned >= limit:
                break
            rep.scanned += 1
            state, detail = self.classify_block(h)
            if state == "ok":
                rep.ok += 1
            elif state == "raw":
                rep.raw += 1
            elif state == "corrupt":
                rep.corrupt.append((h, detail))
            # missing blocks belong to IntegrityVerifier.verify_all
        rep.duration_ms = (time.monotonic() - t0) * 1e3
        self.monitor.record_scan(rep)
        return rep

    # -- quarantine -------------------------------------------------------------
    def quarantine(self, h: str) -> bool:
        """Move the damaged frame out of the CAS, keeping it for forensics."""
        src = self.engine._path(h)
        if not src.exists():
            return False
        self.quarantine_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        while True:
            dst = self.quarantine_dir / f"{h}.{n}"
            if not dst.exists():
                break
            n += 1
        src.rename(dst)
        if self.wal:
            self.wal.append(OP_QUARANTINE, hash=h, dest=dst.name)
        self.monitor.quarantined += 1
        return True

    # -- repair -------------------------------------------------------------------
    def repair(self, corrupt_hashes: list[str], *,
               backend=None, source_bytes=None) -> RepairReport:
        """Quarantine each damaged frame, then rewrite clean bytes from the
        best source:

          1. `backend.get(h)` — an object-storage replica (S3 / checkpoint
             spill) holding the original uncorrupted frame or raw bytes.
          2. `source_bytes(h) -> bytes | None` — the original CONTENT of the
             chunk (e.g. sliced from a document still on the filesystem via
             its manifest); recompressed fresh.

        Every accepted repair is verified (content hash == h) before the
        block re-enters the CAS; a wrong source can't poison it.
        """
        rep = RepairReport()
        for h in corrupt_hashes:
            if self.quarantine(h):
                rep.quarantined += 1
            fixed = None
            if backend is not None:
                try:
                    blob = backend.get(h)
                except Exception:
                    blob = None
                if blob is not None:
                    try:
                        content = (
                            CompressionRegistry.get(
                                CompressionHeader.unpack(blob).algorithm
                            ).decompress(
                                blob[HEADER_SIZE:],
                                CompressionHeader.unpack(blob).original_size)
                            if is_compressed_block(blob) else blob
                        )
                        if sha256_bytes(content) == h:
                            self.engine.store(h, blob)
                            fixed = "backend"
                    except Exception:
                        pass
            if fixed is None and source_bytes is not None:
                try:
                    content = source_bytes(h)
                except Exception:
                    content = None
                if content is not None and sha256_bytes(content) == h:
                    self.engine.store(h, compress_block(content))
                    fixed = "source"
            if fixed:
                rep.repaired.append((h, fixed))
                self.monitor.repaired += 1
            else:
                rep.unrepairable.append(h)
                self.monitor.unrepairable += 1
        return rep


class CompressionTransactionManager:
    """Journaled batch recompression (policy-change migration).

    begin() journals the batch intent to the WAL; each block swap is
    individually atomic (StorageEngine.store = temp+fsync+rename) and
    CONTENT-PRESERVING, so a crash mid-batch leaves every block either old-
    or new-framed — both valid. resume() re-runs any batch whose commit
    record is missing; recompression is idempotent, so replay is safe.
    """

    def __init__(self, raw_engine, wal: WalManager | None = None,
                 monitor: "CompressionMonitor | None" = None):
        self.engine = raw_engine
        self.wal = wal
        self.monitor = monitor or CompressionMonitor()
        self._lock = threading.Lock()

    def recompress(self, hashes: list[str], algorithm: str = "zstd",
                   level: int = 3, min_gain: float = 0.02) -> dict:
        """Re-frame each block with (algorithm, level). Blocks whose current
        frame already matches, or where the new frame saves < min_gain of the
        stored size, are left untouched. Returns a summary dict."""
        with self._lock:
            txid = None
            if self.wal:
                txid = self.wal.append(
                    OP_RECOMPRESS_BEGIN, hashes=list(hashes),
                    algorithm=algorithm, level=level)
                self.wal.sync()
            changed = skipped = failed = 0
            bytes_before = bytes_after = 0
            target_algo = CompressionRegistry.get(algorithm).algo_id
            for h in hashes:
                try:
                    blob = self.engine.retrieve(h)
                    if is_compressed_block(blob):
                        hdr = CompressionHeader.unpack(blob)
                        content = CompressionRegistry.get(
                            hdr.algorithm).decompress(
                            blob[HEADER_SIZE:], hdr.original_size)
                        if (hdr.algorithm, hdr.level) == (target_algo, level):
                            skipped += 1
                            continue
                    else:
                        content = blob
                    if sha256_bytes(content) != h:
                        failed += 1  # damaged: RecoveryManager's job
                        continue
                    new = compress_block(content, algorithm, level)
                    if len(new) > len(blob) * (1.0 - min_gain):
                        skipped += 1
                        continue
                    self.engine.store(h, new, overwrite=True)
                    changed += 1
                    bytes_before += len(blob)
                    bytes_after += len(new)
                except Exception:
                    failed += 1
            if self.wal and txid is not None:
                self.wal.append(OP_RECOMPRESS_COMMIT, txid=txid,
                                changed=changed, failed=failed)
                self.wal.sync()
            self.monitor.record_recompress(changed, bytes_before, bytes_after)
            return {
                "txid": txid, "changed": changed, "skipped": skipped,
                "failed": failed, "bytes_before": bytes_before,
                "bytes_after": bytes_after,
            }

    def resume(self) -> int:
        """Replay recompress batches whose commit record never landed.
        Returns the number of batches resumed."""
        if not self.wal:
            return 0
        open_tx: dict[int, dict] = {}
        for rec in self.wal.replay():
            if rec.get("op") == OP_RECOMPRESS_BEGIN:
                open_tx[rec["seq"]] = rec
            elif rec.get("op") == OP_RECOMPRESS_COMMIT:
                open_tx.pop(rec.get("txid"), None)
        for rec in open_tx.values():
            self.recompress(rec["hashes"], rec["algorithm"], rec["level"])
            # close the ORPHAN batch too (recompress() committed only its own
            # new begin record) so a second resume() finds nothing open
            self.wal.append(OP_RECOMPRESS_COMMIT, txid=rec["seq"], resumed=True)
        if open_tx:
            self.wal.sync()
        return len(open_tx)


class CompressionMonitor:
    """Running counters for the stats/doctor surface
    (reference: compression_monitor.cpp)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.scans = 0
        self.blocks_scanned = 0
        self.corrupt_found = 0
        self.quarantined = 0
        self.repaired = 0
        self.unrepairable = 0
        self.recompressed = 0
        self.recompress_bytes_saved = 0

    def record_scan(self, rep: CompressionScanReport) -> None:
        with self._lock:
            self.scans += 1
            self.blocks_scanned += rep.scanned
            self.corrupt_found += len(rep.corrupt)

    def record_recompress(self, changed: int, before: int, after: int) -> None:
        with self._lock:
            self.recompressed += changed
            self.recompress_bytes_saved += max(0, before - after)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "scans": self.scans,
                "blocks_scanned": self.blocks_scanned,
                "corrupt_found": self.corrupt_found,
                "quarantined": self.quarantined,
                "repaired": self.repaired,
                "unrepairable": self.unrepairable,
                "recompressed": self.recompressed,
                "recompress_bytes_saved": self.recompress_bytes_saved,
            }
