"""Late-interaction (ColBERT-style) MaxSim scoring on the device.

Port of yams_tpu/ops/maxsim.py. Token embeddings are dense (B, Tq, D) /
(B, C, Td, D) tensors and MaxSim is one batched bf16 product with f32 sums
(cuBLAS with an f32 output on the card, as `ops/scan.dot_f32`; an f32
product of the bf16-rounded operands on the CPU) followed by max / sum
reductions:

score(q, d) = sum_t max_s  q_t . d_s     (t over query tokens, s over doc
tokens; a masked doc token scores -1e30, a doc with no live token -1, a
masked query token 0), divided by the live query-token count (at least 1).

`maxsim_rerank` sends invalid candidates (id < 0) to -1e30 and keeps the
top k with lax.top_k's tie order (`ops/select.top_k`).
"""

from __future__ import annotations

import torch

from .select import top_k


def maxsim_scores(q_tok: torch.Tensor, q_mask: torch.Tensor, cand_tok: torch.Tensor,
                  cand_mask: torch.Tensor) -> torch.Tensor:
    """(B, Tq, D) query tokens, (B, Tq) f32 0/1, (B, C, Td, D) candidate
    tokens, (B, C, Td) f32 0/1 -> (B, C) f32 MaxSim scores."""
    B, C, Td, D = cand_tok.shape
    q16 = q_tok.to(torch.bfloat16)
    c16 = cand_tok.to(torch.bfloat16).reshape(B, C * Td, D).transpose(1, 2)
    if q16.device.type == "cuda":
        sims = torch.bmm(q16, c16, out_dtype=torch.float32)
    else:
        sims = torch.bmm(q16.float(), c16.float())
    sims = sims.reshape(B, -1, C, Td).transpose(1, 2)          # (B, C, Tq, Td)
    sims = sims + (cand_mask[:, :, None, :] - 1.0) * 1e30       # mask doc tokens
    best = sims.amax(dim=-1).clamp_min(-1.0)                    # all-masked docs
    best = best * q_mask[:, None, :]                            # mask query tokens
    denom = q_mask.sum(dim=1).clamp_min(1.0)
    return best.sum(dim=-1) / denom[:, None]


def maxsim_rerank(q_tok, q_mask, cand_tok, cand_mask, cand_ids: torch.Tensor, k: int):
    """Re-order candidate ids by MaxSim -> (scores (B, k), ids (B, k))."""
    s = maxsim_scores(q_tok, q_mask, cand_tok, cand_mask)
    s = torch.where(cand_ids >= 0, s, torch.full_like(s, -1e30))
    vals, pos = top_k(s, k)
    return vals, cand_ids.gather(1, pos)
