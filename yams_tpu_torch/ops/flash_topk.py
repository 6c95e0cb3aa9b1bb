"""Fused KNN scan: score product + strided-window top-1, then top-C.

Port of yams_tpu/ops/flash_topk.py. `windowed_scan` never materializes the
(B, N) score matrix: the window kernel K2 reads E once and emits one
(max, argmax) per strided 128-row window and query, (B, N/128). Column
j*128 + w holds the best of rows {j*SPAN + r : r = w (mod 128)}, folded in
increasing row order with a strict `>` from (-1e30, row 0), so ties go to
the first row and a window whose every score is <= -1e30 emits (-1e30, 0).
On a CUDA tensor the window step is `windowed_scan_cuda` (csrc/fused_scan.cu);
on a CPU tensor its plain twin `windowed_scan_reference`. `flash_topc` is the
window scan + an exact top-k over the window matrix; the values are the
f32 sums of the bf16 products, with no rescore. Its only callers are the
experiment yams_tpu_torch/scripts/exp_flash_topk.py and the tests.

WINDOW, BLOCK_ROWS, GROUP and SPAN are the reference's layout: a span of
SPAN = BLOCK_ROWS * GROUP = 16,384 rows folds into WINDOW = 128 columns, and
N must be a multiple of SPAN (`pad_corpus`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .scan import dot_f32
from .select import top_k

WINDOW = 128            # output lanes per span (= windows per span)
BLOCK_ROWS = 512        # corpus rows per inner step of the TPU kernel
GROUP = 32              # inner steps per span
SPAN = BLOCK_ROWS * GROUP   # corpus rows folded into one (B, 128) out block
NEG = -1e30
_SCORE_BUDGET = 1 << 26     # f32 scores per chunk of the plain twin


def windowed_scan_reference(q: torch.Tensor, E: torch.Tensor, bias: torch.Tensor):
    """Plain twin of `windowed_scan_cuda`: (B, N/128) f32 values, i32 rows."""
    B = q.shape[0]
    N = E.shape[0]
    J = N // SPAN
    out_v = torch.empty((B, J * WINDOW), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, J * WINDOW), dtype=torch.int32, device=q.device)
    lane = torch.arange(WINDOW, device=q.device, dtype=torch.int64)
    chunk = torch.arange(SPAN // WINDOW, device=q.device, dtype=torch.int64)[:, None]
    per = max(1, _SCORE_BUDGET // (B * SPAN))
    for j0 in range(0, J, per):
        j1 = min(J, j0 + per)
        lo, hi = j0 * SPAN, j1 * SPAN
        s = dot_f32(q, E[lo:hi]) + bias[lo:hi][None, :]
        s = s.reshape(B, j1 - j0, SPAN // WINDOW, WINDOW)
        m = s.amax(dim=2)
        c = torch.where(s == m[:, :, None], chunk, SPAN).amin(dim=2)   # first row of the max
        rows = (torch.arange(j0, j1, device=q.device)[:, None] * SPAN
                + c * WINDOW + lane)
        take = m > NEG                        # else the scratch's (-1e30, 0)
        cols = slice(j0 * WINDOW, j1 * WINDOW)
        out_v[:, cols] = torch.where(take, m, NEG).reshape(B, -1)
        out_i[:, cols] = torch.where(take, rows, 0).reshape(B, -1).to(torch.int32)
    return out_v, out_i


def windowed_scan_cuda(q: torch.Tensor, E: torch.Tensor, bias: torch.Tensor):
    """Launch the CUDA window kernel (csrc/fused_scan.cu): (B, N/128)."""
    B, D = q.shape
    N = E.shape[0]
    _build.require_aligned("windowed_scan_cuda", q=q, E=E, bias=bias)
    if q.device.type != "cuda" or E.device != q.device or bias.device != q.device:
        raise ValueError(f"windowed_scan_cuda needs CUDA tensors on one card, got {q.device}")
    if q.dtype != torch.bfloat16 or E.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise ValueError("windowed_scan_cuda takes bf16 q and E and f32 bias")
    if not (q.is_contiguous() and E.is_contiguous() and bias.is_contiguous()):
        raise ValueError("windowed_scan_cuda takes contiguous tensors")
    if E.shape[1] != D or bias.shape != (N,) or D % 16:
        raise ValueError(f"shapes q {tuple(q.shape)}, E {tuple(E.shape)}: D % 16 != 0 or mismatch")
    if N % SPAN or N >= 1 << 31:
        raise ValueError(f"N={N}: a multiple of {SPAN} below 2**31 rows (use pad_corpus)")
    W = N // SPAN * WINDOW
    out_v = torch.empty((B, W), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, W), dtype=torch.int32, device=q.device)
    if B == 0 or N == 0:
        return out_v, out_i
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.yt_windowed_scan(q.data_ptr(), E.data_ptr(), bias.data_ptr(),
                               out_v.data_ptr(), out_i.data_ptr(), B, N, D, stream)
    windowed_scan_cuda.launches += 1
    _build.check(err, "windowed_scan_cuda")
    return out_v, out_i


windowed_scan_cuda.launches = 0


def windowed_scan(q: torch.Tensor, E: torch.Tensor, bias: torch.Tensor):
    """(B, D) queries x (N, D) corpus -> per-window (max, argmax), each
    (B, N/SPAN*128). `bias` is a (N,) f32 additive row bias (0 live, -1e30
    masked or padding). N must be a multiple of SPAN (`pad_corpus`)."""
    N = E.shape[0]
    if N % SPAN:
        raise ValueError(f"N={N} % SPAN={SPAN} != 0: use pad_corpus")
    qb = q.to(torch.bfloat16).contiguous()
    Eb = E.to(torch.bfloat16)
    if q.device.type == "cuda":
        return windowed_scan_cuda(qb, Eb, bias)
    if q.device.type == "cpu":
        return windowed_scan_reference(qb, Eb, bias)
    raise ValueError(f"windowed_scan: unsupported device {q.device}")


def flash_topc(q: torch.Tensor, E: torch.Tensor, bias: torch.Tensor, *, k: int):
    """Fused top-C KNN: (vals (B, k) f32, row_idx (B, k) i32). One survivor
    per strided 128-row window, then an exact top-k over the windows."""
    wv, wa = windowed_scan(q, E, bias)
    v, pos = top_k(wv, k)
    return v, wa.gather(1, pos)


def pad_corpus(E: np.ndarray, bias: np.ndarray):
    """Pad (N, D) corpus + (N,) bias so N divides SPAN; padded rows carry
    bias=-1e30 and never surface."""
    N = E.shape[0]
    pad = (-N) % SPAN
    if pad == 0:
        return E, bias
    E2 = np.concatenate([E, np.zeros((pad, E.shape[1]), E.dtype)])
    b2 = np.concatenate([bias, np.full(pad, NEG, np.float32)])
    return E2, b2
