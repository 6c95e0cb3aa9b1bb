"""Matryoshka (prefix-truncated) embedding scan with full-dim rerank.

Port of yams_tpu/ops/matryoshka.py: a contiguous bf16 copy of the first d0
dims is scanned for k * rerank_factor candidates, which are then rescored
at full dimension. The products are bf16 with f32 sums (`ops/scan.dot_f32`
for the scan; a batched product for the rerank, cuBLAS with an f32 output
on the card, an f32 product of the bf16-rounded operands on the CPU).

The candidate selection is exact (`ops/select.top_k`), where the reference
calls lax.approx_max_k, which is approximate on a TPU and exact elsewhere:
judge this op by recall against the exact scan, not by ids.
"""

from __future__ import annotations

import torch

from .scan import dot_f32
from .select import top_k


def prefix_corpus(E: torch.Tensor, d0: int) -> torch.Tensor:
    """Contiguous (N, d0) prefix copy (bf16) for the scan stage."""
    return E[:, :d0].to(torch.bfloat16).contiguous()


def matryoshka_topk(q: torch.Tensor, E: torch.Tensor, E0: torch.Tensor,
                    valid: torch.Tensor, k: int, rerank_factor: int = 8):
    """(B, D) f32 queries, (N, D) bf16 corpus, (N, d0) bf16 prefix, (N,) f32
    validity -> (scores (B, k) f32 at full dimension, row indices (B, k) i32)."""
    d0 = E0.shape[1]
    s0 = dot_f32(q[:, :d0], E0)
    s0 = s0 + (valid - 1.0)[None, :] * 1e30
    C = min(k * rerank_factor, E0.shape[0])
    _, ci = top_k(s0, C)
    cand = E.index_select(0, ci.reshape(-1)).reshape(*ci.shape, -1).to(torch.bfloat16)
    q16 = q.to(torch.bfloat16)[:, :, None]
    if cand.device.type == "cuda":
        full = torch.bmm(cand, q16, out_dtype=torch.float32)[:, :, 0]
    else:
        full = torch.bmm(cand.float(), q16.float())[:, :, 0]
    vals, pos = top_k(full, k)
    return vals, ci.gather(1, pos).to(torch.int32)
