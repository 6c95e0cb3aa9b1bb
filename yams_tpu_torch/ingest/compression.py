"""Compression framework: framed blocks, algorithm registry, policy engine.

Parity with the reference's src/compression/:
  - 40-byte self-describing header with algorithm id + CRC32
    (compression_header.cpp — magic/version/algo/level/sizes/crc).
  - registry of compressors (compression_registry.cpp): zstd (hot tier),
    LZMA (archival tier), none.
  - policy engine mapping (age, size, mime) -> (algorithm, level)
    (compression_policy.cpp).

Copied from yams_tpu/ingest/compression.py (the port imports
nothing of yams_tpu). `zstandard` is imported when a zstd block is first
compressed or read, so the module imports where the package is missing.
"""

from __future__ import annotations

import dataclasses
import lzma
import struct
import zlib

from ..core.config import CompressionConfig
from ..core.errors import CorruptionError, UnsupportedError

MAGIC = 0x59435A31  # "YCZ1"
HEADER_FMT = "<IBBBBQQI12s"  # magic,u8 ver,u8 algo,u8 level,u8 flags,u64 orig,u64 comp,u32 crc,12 pad
HEADER_SIZE = struct.calcsize(HEADER_FMT)
assert HEADER_SIZE == 40

ALGO_NONE = 0
ALGO_ZSTD = 1
ALGO_LZMA = 2

_ALGO_NAMES = {ALGO_NONE: "none", ALGO_ZSTD: "zstd", ALGO_LZMA: "lzma"}
_ALGO_IDS = {v: k for k, v in _ALGO_NAMES.items()}


@dataclasses.dataclass(frozen=True, slots=True)
class CompressionHeader:
    algorithm: int
    level: int
    original_size: int
    compressed_size: int
    crc32: int
    version: int = 1
    flags: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            HEADER_FMT, MAGIC, self.version, self.algorithm, self.level,
            self.flags, self.original_size, self.compressed_size, self.crc32,
            b"\x00" * 12,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "CompressionHeader":
        if len(raw) < HEADER_SIZE:
            raise CorruptionError("compression header truncated")
        magic, ver, algo, level, flags, orig, comp, crc, _ = struct.unpack(
            HEADER_FMT, raw[:HEADER_SIZE]
        )
        if magic != MAGIC:
            raise CorruptionError(f"bad compression magic 0x{magic:08x}")
        return cls(algo, level, orig, comp, crc, ver, flags)


class _Zstd:
    name = "zstd"
    algo_id = ALGO_ZSTD

    @staticmethod
    def compress(data: bytes, level: int) -> bytes:
        import zstandard

        return zstandard.ZstdCompressor(level=level).compress(data)

    @staticmethod
    def decompress(data: bytes, original_size: int) -> bytes:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=max(original_size, 1)
        )


class _Lzma:
    name = "lzma"
    algo_id = ALGO_LZMA

    @staticmethod
    def compress(data: bytes, level: int) -> bytes:
        return lzma.compress(data, preset=level)

    @staticmethod
    def decompress(data: bytes, original_size: int) -> bytes:
        return lzma.decompress(data)


class _NoOp:
    name = "none"
    algo_id = ALGO_NONE

    @staticmethod
    def compress(data: bytes, level: int) -> bytes:
        return data

    @staticmethod
    def decompress(data: bytes, original_size: int) -> bytes:
        return data


class CompressionRegistry:
    """Algorithm registry (reference: compression_registry.cpp)."""

    _by_id = {ALGO_NONE: _NoOp, ALGO_ZSTD: _Zstd, ALGO_LZMA: _Lzma}
    _by_name = {"none": _NoOp, "zstd": _Zstd, "lzma": _Lzma}

    @classmethod
    def get(cls, algo: int | str):
        table = cls._by_name if isinstance(algo, str) else cls._by_id
        try:
            return table[algo]
        except KeyError:
            raise UnsupportedError(f"unknown compression algorithm: {algo!r}")

    @classmethod
    def register(cls, impl) -> None:
        cls._by_id[impl.algo_id] = impl
        cls._by_name[impl.name] = impl


def compress_block(data: bytes, algorithm: str = "zstd", level: int = 3) -> bytes:
    """Compress into a self-describing framed block (header + payload).

    Falls back to ALGO_NONE when compression does not shrink the payload,
    like the reference's CompressedStorageEngine does.
    """
    impl = CompressionRegistry.get(algorithm)
    payload = impl.compress(data, level)
    algo_id = impl.algo_id
    if len(payload) >= len(data) and algo_id != ALGO_NONE:
        payload, algo_id, level = data, ALGO_NONE, 0
    header = CompressionHeader(
        algorithm=algo_id,
        level=level,
        original_size=len(data),
        compressed_size=len(payload),
        crc32=zlib.crc32(payload) & 0xFFFFFFFF,
    )
    return header.pack() + payload


def decompress_block(block: bytes) -> bytes:
    header = CompressionHeader.unpack(block)
    payload = block[HEADER_SIZE : HEADER_SIZE + header.compressed_size]
    if len(payload) != header.compressed_size:
        raise CorruptionError("compressed payload truncated")
    if zlib.crc32(payload) & 0xFFFFFFFF != header.crc32:
        raise CorruptionError("compressed payload CRC mismatch")
    out = CompressionRegistry.get(header.algorithm).decompress(
        payload, header.original_size
    )
    if len(out) != header.original_size:
        raise CorruptionError("decompressed size mismatch")
    return out


def is_compressed_block(block: bytes) -> bool:
    """True only when the block is actually framed, not a raw block whose
    content happens to start with the magic bytes.

    The full header must parse, the algorithm must be known, the length must
    be exactly HEADER_SIZE + compressed_size, and the payload CRC must match
    (the reference's isCompressedData applies the same size discipline,
    compressed_storage_engine.cpp:30-46). A 4-byte magic sniff would make
    adversarial raw content permanently unretrievable.
    """
    if len(block) < HEADER_SIZE:
        return False
    try:
        header = CompressionHeader.unpack(block)
    except CorruptionError:
        return False
    if header.algorithm not in _ALGO_NAMES:
        return False
    if len(block) != HEADER_SIZE + header.compressed_size:
        return False
    return zlib.crc32(block[HEADER_SIZE:]) & 0xFFFFFFFF == header.crc32


@dataclasses.dataclass(slots=True)
class CompressionDecision:
    compress: bool
    algorithm: str = "zstd"
    level: int = 3


class CompressionPolicy:
    """(size, mime, age) -> decision (reference: compression_policy.cpp)."""

    def __init__(self, config: CompressionConfig | None = None):
        self.config = config or CompressionConfig()

    def decide(
        self, size: int, mime_type: str = "", age_days: float = 0.0,
        hot: bool = False,
    ) -> CompressionDecision:
        """hot=True selects the ingest-path tier (zstd_hot_level, default 1):
        cheapest compression on the write path; the age policy recompresses
        to zstd_level / LZMA later (reference: per-tier compression policy,
        compression_policy.cpp)."""
        c = self.config
        if not c.enabled or size < c.min_size:
            return CompressionDecision(False)
        for prefix in c.incompressible_types:
            if mime_type.startswith(prefix):
                return CompressionDecision(False)
        if age_days >= c.archive_after_days:
            return CompressionDecision(True, "lzma", c.lzma_level)
        if hot:
            return CompressionDecision(True, c.algorithm, c.zstd_hot_level)
        return CompressionDecision(True, c.algorithm, c.zstd_level)
