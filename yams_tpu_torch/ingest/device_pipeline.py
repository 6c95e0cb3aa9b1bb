"""Device ingest tier: CDC boundaries + per-chunk SHA-256 on the card.

Port of yams_tpu/ingest/device_pipeline.py. The payload is copied to the
device once; both stages read that one buffer:

  1. gear-hash boundary candidates on the device (ops.cdc), bit-identical to
     the host chunkers, with the greedy cut selection on the host;
  2. per-chunk SHA-256 on the device (ops.sha256), one thread per chunk,
     reading each chunk in place at its (start, length), bit-identical to
     hashlib. No (n_chunks, longest) padded matrix is built (it would be
     ~0.5 GB at a 128 MiB payload).

Routing (`available`): YAMS_DEVICE_INGEST=0 disables, =1 forces (on any
device, the CPU included), default auto: payloads of at least
DEVICE_MIN_BYTES on a CUDA device. A device failure raises; there is no host
fallback here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.cdc import boundaries_device
from ..ops.sha256 import sha256_rows

DEVICE_MIN_BYTES = int(os.environ.get("YAMS_DEVICE_INGEST_MIN",
                                      32 * 1024 * 1024))


def available(n_bytes: int, device: torch.device) -> bool:
    mode = os.environ.get("YAMS_DEVICE_INGEST", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return n_bytes >= DEVICE_MIN_BYTES and device.type == "cuda"


def payload_tensor(data: bytes, device: torch.device) -> torch.Tensor:
    """bytes -> (N,) uint8 tensor on `device` (one host copy, one upload)."""
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else \
        torch.empty(0, dtype=torch.uint8)
    return buf.to(device)


def device_chunk_hash(
    data: bytes, min_size: int, avg_size: int, max_size: int,
    device: torch.device,
) -> list[tuple[str, int, int]]:
    """-> [(sha256 hex, start, end), ...] covering data exactly.

    Boundaries are bit-identical to FastCDCChunker.boundaries; digests are
    bit-identical to hashlib.sha256 over each chunk."""
    if not data:
        return []
    buf = payload_tensor(data, device)
    bounds = boundaries_device(buf, min_size, avg_size, max_size)
    ends = np.asarray(bounds, np.int64)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    lengths = (ends - starts).astype(np.int32)
    dig = sha256_rows(
        buf, torch.from_numpy(starts).to(device),
        torch.from_numpy(lengths).to(device),
    ).cpu().numpy()
    return [
        (dig[i].tobytes().hex(), int(starts[i]), int(ends[i]))
        for i in range(len(ends))
    ]
