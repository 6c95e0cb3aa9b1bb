"""BM25 top-C candidates from impact-ordered postings, on torch tensors.

Port of yams_tpu/ops/bm25.py (`bm25_topk_candidates_packed`, the main path,
and the CSR form `bm25_topk_candidates`). The lexical leg is dense tensor
work over precomputed per-posting impacts: gather the query terms' windows,
sort by doc id, segmented sum via a prefix sum and a cummax forward fill of the
segment bases (impacts are >= 0, so bases are monotone), then top-C over the
per-segment totals. `packed_qbits` and `pack_postings_2d` are host NumPy,
copied from the reference (whose module imports jax).

Sentinels are the reference's: empty candidates carry id `num_docs`, and the
packed sink key is `num_docs << qbits`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .select import prefix_sum, top_k


@dataclasses.dataclass
class Bm25Arrays:
    """Device lexical index arrays (one segment); see the reference's
    Bm25Arrays. `packed`/`impact_scale` are present when V*window fits the
    configured budget; otherwise queries take the CSR path."""

    postings_doc: torch.Tensor     # (P + window,) i32
    postings_impact: torch.Tensor  # (P + window,) f32
    term_offsets: torch.Tensor     # (V,) i32
    term_lengths: torch.Tensor     # (V,) i32
    num_docs: int
    packed: torch.Tensor | None = None        # (V, window) i32
    impact_scale: torch.Tensor | None = None  # () f32


def packed_qbits(num_docs: int) -> int:
    """Low bits available for the quantized impact when doc ids (plus the
    sink id == num_docs) occupy the high bits of a signed int32 key."""
    id_bits = int(np.ceil(np.log2(num_docs + 2)))
    return max(31 - id_bits, 1)


def pack_postings_2d(
    postings_doc, postings_impact, term_offsets, term_lengths,
    *, window: int, num_docs: int,
):
    """CSR postings -> dense packed (V, window) i32 + impact scale.

    Row v holds term v's (<= window, impact-ordered) postings, each packed as
    `doc_id << qbits | quantized_impact` and sink-padded.
    Returns (packed (V, window) i32 numpy, impact_scale float)."""
    pd = np.asarray(postings_doc)
    pi = np.asarray(postings_impact)
    to = np.asarray(term_offsets)
    tl = np.asarray(term_lengths)
    qbits = packed_qbits(num_docs)
    qmax = (1 << qbits) - 1
    scale = float(pi.max()) if pi.size else 1.0
    scale = max(scale, 1e-9)
    idx = to[:, None].astype(np.int64) + np.arange(window)[None, :]
    ok = np.arange(window)[None, :] < tl[:, None]
    idx = np.clip(idx, 0, len(pd) - 1)
    docs = np.where(ok, pd[idx], num_docs).astype(np.int32)
    quant = np.clip(
        np.round(np.where(ok, pi[idx], 0.0) * (qmax / scale)), 0, qmax
    ).astype(np.int32)
    packed = (docs << qbits) | quant
    return packed, scale


def _segment_topk(
    ids: torch.Tensor, val: torch.Tensor, num_docs: int, num_candidates: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Doc-sorted (B, L) ids + values -> top-C (ids, per-doc sums)."""
    cs = prefix_sum(val)
    change = ids[:, 1:] != ids[:, :-1]
    edge = torch.ones_like(ids[:, :1], dtype=torch.bool)
    first = torch.cat([edge, change], dim=1)
    last = torch.cat([change, edge], dim=1)
    base = torch.where(first, cs - val, -torch.inf).cummax(dim=1).values
    seg_total = torch.where(last & (ids < num_docs), cs - base, 0.0)
    c_scores, c_pos = top_k(seg_total, num_candidates)
    c_ids = torch.where(c_scores > 0, ids.gather(1, c_pos), num_docs)
    return c_ids.to(torch.int32), c_scores


def bm25_topk_candidates_packed(
    term_ids: torch.Tensor,      # (B, T) i32
    term_mask: torch.Tensor,     # (B, T) f32 term weights in [0, 1]
    packed: torch.Tensor,        # (V, window) i32 from pack_postings_2d
    impact_scale: torch.Tensor,  # () or (1,) f32
    *,
    num_docs: int,
    num_candidates: int = 64,
    prefilter: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-C BM25 candidates from packed 2-D postings -> (ids (B, C) i32,
    scores (B, C) f32), rank-ordered; id num_docs marks an empty slot."""
    window = packed.shape[1]
    take = prefilter if 0 < prefilter < window else window
    qbits = packed_qbits(num_docs)
    qmax = (1 << qbits) - 1
    sink_key = num_docs << qbits
    scale = impact_scale.reshape(())
    keys = packed[term_ids.long(), :take]               # (B, T, take)
    # fractional term weights scale the quantized impact in the LOW bits;
    # doc ids in the high bits stay sort-stable
    q = (keys & qmax).float() * term_mask.clamp(0.0, 1.0)[:, :, None]
    keys = (keys & ~qmax) | q.to(torch.int32)
    keys = torch.where(term_mask[:, :, None] > 0, keys, sink_key)
    keys = keys.reshape(keys.shape[0], -1).sort(dim=1).values
    ids = keys >> qbits
    val = (keys & qmax).float() * (scale / qmax)
    return _segment_topk(ids, val, num_docs, num_candidates)


def bm25_topk_candidates(
    term_ids: torch.Tensor,
    term_mask: torch.Tensor,
    postings_doc: torch.Tensor,
    postings_impact: torch.Tensor,
    term_offsets: torch.Tensor,
    term_lengths: torch.Tensor,
    *,
    window: int,
    num_docs: int,
    num_candidates: int = 64,
    prefilter: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR form of bm25_topk_candidates_packed (same contract): each term's
    window is a contiguous slice of the flat postings arrays."""
    P = postings_doc.shape[0]
    take = prefilter if 0 < prefilter < window else window
    tid = term_ids.long()
    off = term_offsets.long()[tid].clamp(0, P - take)          # (B, T)
    pos = torch.arange(take, device=tid.device)
    idx = off[:, :, None] + pos                                  # (B, T, take)
    pmask = (pos < term_lengths.long()[tid][:, :, None]) \
        & (term_mask[:, :, None] > 0)
    contrib = torch.where(pmask, postings_impact[idx] * term_mask[:, :, None],
                          0.0)
    docs = torch.where(pmask, postings_doc[idx].long(), num_docs)
    B = tid.shape[0]
    ids, order = docs.reshape(B, -1).sort(dim=1, stable=True)
    val = contrib.reshape(B, -1).gather(1, order)
    return _segment_topk(ids, val, num_docs, num_candidates)
