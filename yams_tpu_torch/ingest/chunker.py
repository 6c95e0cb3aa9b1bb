"""FastCDC content-defined chunking on the host: gear table, masks, the
vectorized NumPy chunker and `FastCDCChunker`.

Copied from yams_tpu/ingest/chunker.py (`GEAR_SEED`, `_splitmix64`,
`gear_table`, `_masks`, `_boundaries_numpy`, `FastCDCChunker`);
tests/test_torch_cdc.py pins them equal to the originals. `FastCDCChunker`
runs the port's native FastCDC (yams_tpu_torch/native) when its library
builds, else the NumPy chunker; both give the same boundaries. This is also
the host oracle the device chunker is held to.
"""

from __future__ import annotations

import functools
import pathlib
from typing import Iterator

import numpy as np

from .. import native
from ..core.config import ChunkingConfig
from ..core.types import Chunk, ChunkRef
from .hasher import sha256_bytes

GEAR_SEED = 0x59414D5354505500  # "YAMSTPU\0" — must match yams_native.cpp

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK64


@functools.cache
def gear_table() -> np.ndarray:
    """256-entry random 32-bit gear table (shared with the C++ library)."""
    return np.array(
        [_splitmix64(GEAR_SEED + i) >> 32 for i in range(256)], dtype=np.uint32
    )


def _masks(avg_size: int) -> tuple[int, int]:
    bits = avg_size.bit_length() - 1
    return (1 << (bits + 2)) - 1, (1 << (bits - 2)) - 1


def select_cuts(
    n: int, cand_s: np.ndarray, cand_l: np.ndarray,
    min_size: int, avg_size: int, max_size: int,
) -> list[int]:
    """Greedy min/avg/max cut selection over sorted candidate positions."""
    out: list[int] = []
    pos = 0
    while pos < n:
        remaining = n - pos
        if remaining <= min_size:
            out.append(n)
            break
        cap = min(remaining, max_size)
        mid = min(remaining, avg_size)
        cut = cap
        # first s-candidate at absolute index in [pos+min_size, pos+mid)
        i = np.searchsorted(cand_s, pos + min_size)
        if i < len(cand_s) and cand_s[i] < pos + mid:
            cut = int(cand_s[i]) - pos + 1
        else:
            j = np.searchsorted(cand_l, pos + mid)
            if j < len(cand_l) and cand_l[j] < pos + cap:
                cut = int(cand_l[j]) - pos + 1
        pos += cut
        out.append(pos)
    return out


def _boundaries_numpy(
    data: bytes, min_size: int, avg_size: int, max_size: int
) -> list[int]:
    """Vectorized windowed gear hash + sparse greedy cut selection."""
    n = len(data)
    if n == 0:
        return []
    if n <= min_size:
        return [n]
    mask_s, mask_l = _masks(avg_size)
    gear = gear_table()
    g = gear[np.frombuffer(data, dtype=np.uint8)]
    # h[i] = sum_{j<32} gear[b_{i-j}] << j  (mod 2^32) == sequential gear hash
    U32 = np.uint32
    with np.errstate(over="ignore"):
        h = g.copy()
        for j in range(1, 32):
            h[j:] += g[: n - j] << U32(j)
    cand_s = np.nonzero((h & U32(mask_s)) == 0)[0]
    cand_l = np.nonzero((h & U32(mask_l)) == 0)[0]
    return select_cuts(n, cand_s, cand_l, min_size, avg_size, max_size)


class FastCDCChunker:
    """Content-defined chunker (API parity: include/yams/chunking/chunker.h:65-95)."""

    def __init__(self, config: ChunkingConfig | None = None, use_native: bool = True):
        self.config = config or ChunkingConfig()
        assert self.config.min_size >= 256
        assert self.config.min_size <= self.config.avg_size <= self.config.max_size
        self._use_native = use_native

    # -- boundary computation -------------------------------------------------
    def boundaries(self, data: bytes) -> list[int]:
        """Chunk end-offsets (last one == len(data))."""
        c = self.config
        if self._use_native:
            b = native.fastcdc_boundaries(data, c.min_size, c.avg_size, c.max_size)
            if b is not None:
                return b
        return _boundaries_numpy(data, c.min_size, c.avg_size, c.max_size)

    # -- chunking --------------------------------------------------------------
    def chunk_bytes(self, data: bytes) -> list[Chunk]:
        chunks: list[Chunk] = []
        start = 0
        for end in self.boundaries(data):
            blob = data[start:end]
            chunks.append(
                Chunk(ref=ChunkRef(sha256_bytes(blob), start, len(blob)), data=blob)
            )
            start = end
        return chunks

    def chunk_file(
        self, path: str | pathlib.Path, read_size: int = 8 * 1024 * 1024
    ) -> Iterator[Chunk]:
        """Streaming, bounded-memory chunking (reference: streaming_chunker.cpp).

        A cut decision needs at most max_size bytes of lookahead, so we only
        emit chunks whose window is fully buffered and carry the tail forward.
        """
        c = self.config
        offset = 0
        buf = b""
        with open(path, "rb") as f:
            while True:
                block = f.read(read_size)
                eof = not block
                buf += block
                if not eof and len(buf) < c.max_size * 2:
                    continue
                ends = self.boundaries(buf)
                start = 0
                for end in ends:
                    if not eof and len(buf) - start <= c.max_size:
                        break  # decision may change with more data
                    blob = buf[start:end]
                    yield Chunk(
                        ref=ChunkRef(sha256_bytes(blob), offset + start, len(blob)),
                        data=blob,
                    )
                    start = end
                buf = buf[start:]
                offset += start
                if eof:
                    break
        assert not buf, "streaming chunker left unconsumed tail"
