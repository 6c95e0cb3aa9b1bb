"""Grouped ADC scan for the packed 4-bit PQ capacity tier (K4).

Port of yams_tpu/ops/pq_pallas.py. `pq4_adc_grouped` builds the per-query
LUT (q . centroids per subspace, f32, rounded to bf16, as the reference
does) and runs the grouped scan: on a CUDA tensor the CUDA kernel
`pq4_adc_cuda` (csrc/pq4_adc.cu), on a CPU tensor its plain twin
`pq4_adc_reference`. The LUT layout is (B, m, 16): the reference's
value-major, parity-split column layout served its MXU matmul only.

`pq4_adc_topk_pallas` selects the top-k window maxima. The reference uses
lax.approx_max_k, which is exact off the TPU; the port uses the exact
`ops.select.top_k` over the same width.
"""

from __future__ import annotations

import torch

from .. import _build
from .pq import adc_scores, grouped_max, pq4_unpack, pq_lut
from .scan import _chunk_rows
from .select import top_k


def _check_shapes(N: int, group: int, block_rows: int) -> None:
    if N % block_rows or block_rows % group:
        raise ValueError(f"N={N} % block_rows={block_rows} % group={group}")


def pq4_adc_reference(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
                      group: int, block_rows: int = 2048):
    """Plain twin of `pq4_adc_cuda`: per-subspace gathers from the bf16 LUT
    summed in f32, the validity bias, then per window (max, first argmax),
    in row chunks. -> ((B, N/group) f32, (B, N/group) i32 rows)."""
    B = lut.shape[0]
    N = codes.shape[0]
    _check_shapes(N, group, block_rows)
    out_v = torch.empty((B, N // group), dtype=torch.float32, device=lut.device)
    out_i = torch.empty((B, N // group), dtype=torch.int32, device=lut.device)
    step = _chunk_rows(B, block_rows)
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        s = adc_scores(lut, pq4_unpack(codes[lo:hi]))
        s += ((valid[lo:hi] - 1.0) * 1e30)[None, :]
        v, rows = grouped_max(s, group)
        out_v[:, lo // group:hi // group] = v
        out_i[:, lo // group:hi // group] = (rows + lo).to(torch.int32)
    return out_v, out_i


def pq4_adc_cuda(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
                 group: int, block_rows: int = 2048):
    """Launch the CUDA grouped ADC kernel (csrc/pq4_adc.cu): the one-hot
    product on the tensor cores, the LUT resident in shared memory."""
    B, m, ksub = lut.shape
    N, mp = codes.shape
    if lut.device.type != "cuda" or codes.device != lut.device or valid.device != lut.device:
        raise ValueError(f"pq4_adc_cuda needs CUDA tensors on one card, got {lut.device}")
    if lut.dtype != torch.bfloat16 or codes.dtype != torch.uint8 or valid.dtype != torch.float32:
        raise ValueError("pq4_adc_cuda takes a bf16 LUT, uint8 codes and f32 valid")
    if not (lut.is_contiguous() and codes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("pq4_adc_cuda takes contiguous tensors")
    if ksub != 16 or m != 2 * mp or valid.shape != (N,) or m > 200:
        raise ValueError(f"LUT {tuple(lut.shape)} vs codes {tuple(codes.shape)}: "
                         "ksub 16, m = 2 * code bytes <= 200")
    if 256 % group:
        raise ValueError(f"group {group} must be a power of two <= 256")
    _check_shapes(N, group, block_rows)
    if N >= 1 << 31:
        raise ValueError(f"N={N}: rows are int32")
    _build.require_aligned("pq4_adc_cuda", lut=lut, codes=codes)
    out_v = torch.empty((B, N // group), dtype=torch.float32, device=lut.device)
    out_i = torch.empty((B, N // group), dtype=torch.int32, device=lut.device)
    if B == 0 or N == 0:
        return out_v, out_i
    lib = _build.library()
    stream = torch.cuda.current_stream(lut.device).cuda_stream
    err = lib.yt_pq4_adc(lut.data_ptr(), codes.data_ptr(), valid.data_ptr(),
                         out_v.data_ptr(), out_i.data_ptr(), B, m, N, group, stream)
    pq4_adc_cuda.launches += 1
    _build.check(err, "pq4_adc_cuda")
    return out_v, out_i


pq4_adc_cuda.launches = 0


def pq4_adc_grouped(queries: torch.Tensor, packed: torch.Tensor,
                    centroids: torch.Tensor, valid: torch.Tensor, *,
                    group: int = 64, block_rows: int = 2048):
    """Grouped ADC scan -> ((B, N/group) window maxima, (B, N/group) rows)."""
    if centroids.shape[1] != 16:
        raise ValueError("the grouped ADC kernel is the ksub=16 (PQ4) tier")
    lut = pq_lut(queries, centroids).to(torch.bfloat16).contiguous()
    if queries.device.type == "cuda":
        return pq4_adc_cuda(lut, packed, valid, group, block_rows)
    if queries.device.type == "cpu":
        return pq4_adc_reference(lut, packed, valid, group, block_rows)
    raise ValueError(f"pq4_adc_grouped: unsupported device {queries.device}")


def pq4_adc_topk_pallas(queries: torch.Tensor, packed: torch.Tensor,
                        centroids: torch.Tensor, valid: torch.Tensor, k: int, *,
                        group: int = 64, block_rows: int = 2048, sel_width: int = 0):
    """pq_adc_topk(packed4=True, group>1) on the unfiltered path: (B, k) ADC
    values + rows, one candidate per `group`-row window. The selection is
    the top `max(k, sel_width)` windows (at most all of them), sliced to k."""
    vals, rows = pq4_adc_grouped(queries, packed, centroids, valid,
                                 group=group, block_rows=block_rows)
    w = min(max(k, sel_width), vals.shape[-1])
    v, pos = top_k(vals, w)
    return v[:, :k], rows.gather(1, pos[:, :k])
