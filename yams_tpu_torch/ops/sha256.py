"""Batched SHA-256 on the device: hash thousands of chunks in parallel.

Port of yams_tpu/ops/sha256.py. SHA-256 is sequential along one message,
but a content-addressed store ingests thousands of chunks per batch, so the
natural device shape is one lane per chunk.

- `sha256_pad_bytes`, `sha256_blocks`, `digest_bytes`: the reference's
  contract in plain torch ((N, Lp) uint8 rows + (N,) lengths -> padded words
  -> (N, 8) state -> (N, 32) uint8 digests). `sha256_reference` chains them;
  it is the CPU path and the card-side oracle.
- `sha256_cuda`: the CUDA kernel (csrc/sha256.cu), one thread per message,
  padding applied on the fly, reading each row straight out of a flat byte
  buffer at (starts, lengths) so ingest never builds a padded matrix.
- `sha256_rows` routes by device; `sha256_batch` is the reference's
  padded-matrix entry point on top of it.

uint32 words ride in int64 tensors: torch has no uint32 arithmetic, and an
int64 keeps right shifts logical (values stay in [0, 2^32) after masking).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.int64)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.int64)

_M32 = 0xFFFFFFFF


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) | ((x << (32 - r)) & _M32)


def sha256_pad_bytes(
    data: torch.Tensor, lengths: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, Lp) uint8 zero-padded rows + (N,) lengths -> ((N, Lp//64, 16)
    int64 big-endian words holding uint32 values, (N,) int64 block counts).
    Lp must be a multiple of 64 with Lp >= max(length) + 9 rounded up."""
    n, lp = data.shape
    ln = lengths.to(torch.int64)[:, None]
    pos = torch.arange(lp, device=data.device)[None, :]
    b = torch.where(pos < ln, data.to(torch.int64), 0)
    b = torch.where(pos == ln, 0x80, b)
    nblk = (lengths.to(torch.int64) + 9 + 63) // 64
    end = nblk[:, None] * 64
    k = pos - (end - 8)                       # 0..7 inside the length field
    bits = ln * 8
    in_field = (k >= 0) & (k < 8)
    lenbyte = (bits >> ((7 - k.clamp(0, 7)) * 8)) & 0xFF
    b = torch.where(in_field, lenbyte, b)
    w = b.reshape(n, lp // 4, 4)
    words = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]
    return words.reshape(n, lp // 64, 16), nblk


def sha256_blocks(words: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """(N, nb, 16) int64 words + (N,) live block counts -> (N, 8) int64
    state. Rows run their blocks in lockstep; a row's state freezes once its
    blocks are exhausted."""
    dev = words.device
    k = torch.from_numpy(_K).to(dev)
    state = torch.from_numpy(_H0).to(dev).expand(words.shape[0], 8).clone()
    for bi in range(words.shape[1]):
        w = list(words[:, bi, :].unbind(1))
        for t in range(16, 64):
            s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
        a, b, c, d, e, f, g, h = state.unbind(1)
        for t in range(64):
            s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ ((e ^ _M32) & g)
            t1 = h + s1 + ch + k[t] + w[t]
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            h, g, f, e = g, f, e, (d + t1) & _M32
            d, c, b, a = c, b, a, (t1 + s0 + maj) & _M32
        new = (torch.stack([a, b, c, d, e, f, g, h], dim=1) + state) & _M32
        live = (bi < n_blocks)[:, None]
        state = torch.where(live, new, state)
    return state


def digest_bytes(state: torch.Tensor) -> torch.Tensor:
    """(N, 8) uint32-valued state -> (N, 32) uint8 big-endian digests."""
    out = torch.stack([(state >> s) & 0xFF for s in (24, 16, 8, 0)], dim=2)
    return out.to(torch.uint8).reshape(state.shape[0], 32)


def _padded_rows(
    data: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
) -> torch.Tensor:
    """Gather rows data[starts[i] : starts[i]+lengths[i]] into an (N, Lp)
    zero-padded matrix with Lp = round_up(max(length) + 9, 64)."""
    longest = int(lengths.max()) if lengths.numel() else 0
    lp = ((longest + 9 + 63) // 64) * 64
    pos = torch.arange(lp, device=data.device)[None, :]
    ok = pos < lengths.to(torch.int64)[:, None]
    idx = torch.where(ok, starts.to(torch.int64)[:, None] + pos, 0)
    flat = data if data.numel() else torch.zeros(1, dtype=torch.uint8,
                                                 device=data.device)
    return torch.where(ok, flat[idx], 0).to(torch.uint8)


def sha256_reference(
    data: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
) -> torch.Tensor:
    """Plain-torch twin of sha256_cuda: (flat uint8, (N,) starts, (N,)
    lengths) -> (N, 32) uint8 digests."""
    mat = _padded_rows(data, starts, lengths)
    words, nblk = sha256_pad_bytes(mat, lengths)
    return digest_bytes(sha256_blocks(words, nblk))


def sha256_cuda(
    data: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA SHA-256 kernel (csrc/sha256.cu).

    data: flat contiguous uint8 on the card; starts: (N,) int64 byte
    offsets; lengths: (N,) int32. Returns (N, 32) uint8 digests."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"sha256_cuda needs CUDA tensors, got {dev}")
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("sha256_cuda takes a flat contiguous uint8 buffer")
    if (starts.dtype != torch.int64 or lengths.dtype != torch.int32
            or starts.device != dev or lengths.device != dev
            or starts.shape != lengths.shape or starts.dim() != 1
            or not starts.is_contiguous() or not lengths.is_contiguous()):
        raise ValueError("sha256_cuda takes (N,) int64 starts and (N,) int32 "
                         "lengths, contiguous, on the data's device")
    n = starts.shape[0]
    if n and (int(starts.min()) < 0 or int(lengths.min()) < 0
              or int((starts + lengths).max()) > data.shape[0]):
        raise ValueError("sha256_cuda: a row reaches outside the buffer")
    lib = _build.library()
    out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.yt_sha256_rows(data.data_ptr(), starts.data_ptr(),
                             lengths.data_ptr(), out.data_ptr(), n, stream)
    sha256_cuda.launches += 1
    _build.check(err, "sha256_cuda")
    return out


sha256_cuda.launches = 0


def sha256_rows(
    data: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
) -> torch.Tensor:
    """Digests of the byte ranges data[starts[i]:starts[i]+lengths[i]]:
    the kernel on a card, the twin on the CPU."""
    if data.device.type == "cuda":
        return sha256_cuda(data, starts, lengths)
    if data.device.type == "cpu":
        return sha256_reference(data, starts, lengths)
    raise ValueError(f"sha256_rows: unsupported device {data.device}")


def sha256_batch(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(N, Lp) uint8 + (N,) lengths -> (N, 32) uint8 digests (the
    reference's contract)."""
    n, lp = data.shape
    starts = torch.arange(n, dtype=torch.int64, device=data.device) * lp
    return sha256_rows(data.contiguous().reshape(-1), starts,
                       lengths.to(torch.int32).contiguous())
