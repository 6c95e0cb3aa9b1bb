"""Content-defined chunking on the device: gear-hash boundary candidates.

Port of yams_tpu/ops/cdc.py. The gear hash's 32-byte self-flushing window
makes it position-parallel:

    h[i] = sum_{j<32} GEAR[b[i-j]] << j   (mod 2^32)

which equals the sequential h = (h << 1) + GEAR[b] at every position, so
device candidates are bit-identical to the host chunkers'.

Split: the device does the byte -> gear lookup (a 256-entry table gather),
the 32-term hash (`gear_hash`: the CUDA kernel `gear_hash_cuda` on a card,
its plain twin `gear_hash_reference` on the CPU) and the candidate masks;
only the sparse candidate positions return to the host, which runs the greedy
min/avg/max cut selection unchanged (ingest/chunker.select_cuts).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..ingest.chunker import _masks, gear_table, select_cuts

WINDOW = 32


def gear_hash_reference(g: torch.Tensor) -> torch.Tensor:
    """(N,) int32 gear values -> (N,) int32 rolling hashes, in plain torch.

    Port of gear_hash_xla. int32 shifts and adds wrap like uint32 mod 2^32
    (left shifts only, so torch's arithmetic right shift never enters)."""
    h = g.clone()
    for j in range(1, WINDOW):
        h[j:] += g[: g.shape[0] - j] << j
    return h


def gear_hash_cuda(g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA gear-hash kernel (csrc/gear_hash.cu) on a card tensor."""
    if g.device.type != "cuda":
        raise ValueError(f"gear_hash_cuda needs a CUDA tensor, got {g.device}")
    if g.dtype != torch.int32 or g.dim() != 1 or not g.is_contiguous():
        raise ValueError("gear_hash_cuda takes a contiguous (N,) int32 tensor")
    lib = _build.library()
    out = torch.empty_like(g)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.yt_gear_hash(g.data_ptr(), out.data_ptr(), g.shape[0], stream)
    gear_hash_cuda.launches += 1
    _build.check(err, "gear_hash_cuda")
    return out


gear_hash_cuda.launches = 0


def gear_hash(g: torch.Tensor) -> torch.Tensor:
    """(N,) int32 -> (N,) int32: the kernel on a card, the twin on the CPU."""
    if g.device.type == "cuda":
        return gear_hash_cuda(g)
    if g.device.type == "cpu":
        return gear_hash_reference(g)
    raise ValueError(f"gear_hash: unsupported device {g.device}")


def gear_values(data: torch.Tensor) -> torch.Tensor:
    """(N,) uint8 bytes -> (N,) int32 gear values on the bytes' device."""
    table = torch.from_numpy(gear_table().view(np.int32)).to(data.device)
    return table[data.long()]


def candidates_device(
    data: torch.Tensor, avg_size: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Boundary candidate positions of a (N,) uint8 payload tensor.

    Returns (cand_s, cand_l) sorted int64 position arrays on the host,
    identical to the NumPy chunker's candidate sets."""
    mask_s, mask_l = _masks(avg_size)
    h = gear_hash(gear_values(data))
    # both masks are < 2^31, so the signed int32 AND is the uint32 AND
    cand_s = torch.nonzero((h & mask_s) == 0).flatten()
    cand_l = torch.nonzero((h & mask_l) == 0).flatten()
    return cand_s.cpu().numpy(), cand_l.cpu().numpy()


def boundaries_device(
    data: torch.Tensor, min_size: int, avg_size: int, max_size: int,
) -> list[int]:
    """Chunk end offsets of a (N,) uint8 payload tensor: device hash + host
    greedy cut selection. Bit-identical to FastCDCChunker.boundaries."""
    n = int(data.shape[0])
    if n == 0:
        return []
    if n <= min_size:
        return [n]
    cand_s, cand_l = candidates_device(data, avg_size)
    return select_cuts(n, cand_s, cand_l, min_size, avg_size, max_size)
