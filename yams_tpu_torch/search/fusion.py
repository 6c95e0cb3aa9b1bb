"""The hybrid query: embed ∥ BM25 ∥ KNN -> fuse -> top-k, on torch tensors.

Port of yams_tpu/search/fusion.py for the engine's dense tier. Stages:

  1. query embed: sketch @ proj (bf16 operands, f32 result) -> L2 normalize;
  2. vector leg: q · Eᵀ with f32 scores from bf16 operands, chunk -> doc
     segment max (or rows_are_docs), filter pushdown, top-C;
  3. lexical leg: BM25 top-C candidates (ops.bm25);
  4. candidate fusion over the 2C candidates: weighted evidence + RRF,
     adaptive leg weights, vector-only penalty, hotzone boost;
  5. exact top-k over the merged candidates.

Differences from the reference, all deliberate:
- "approx" selection is exact (lax.approx_max_k is exact off the TPU as
  well, so CPU parity is exact);
- the streaming blocked scan (`scan_block_rows`), the int8 corpus, and the
  "sum" / "topk_avg" chunk aggregations raise NotImplementedError;
- lax.sort(num_keys=1) in the merge becomes a stable sort by id + gathers;
  lax.top_k and jnp.cumsum become ops.select's top_k / prefix_sum, which
  keep the reference's tie order and summation order;
- the (B, rows) score matrix is updated in place for the validity bias and
  the doc mask, so one f32 (B, rows) buffer is live instead of three.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bm25 import bm25_topk_candidates, bm25_topk_candidates_packed
from ..ops.scan import dot_f32
from ..ops.select import prefix_sum, top_k

NEG = -1e30

# packed weight vector layout (yams_tpu/search/fusion.py)
(W_TEXT, W_VEC, W_HOT, W_RRF_SCALE, W_BM25_DIV, W_VEC_ONLY_PEN, W_K1,
 W_RRF_K, W_VEC_BIAS, W_VEC_SCALE, W_LEG_ADAPT, W_CONF_MARGIN) = range(12)
NUM_WEIGHTS = 12


def pack_weights(cfg) -> np.ndarray:
    """SearchEngineConfig -> (NUM_WEIGHTS,) f32 host vector."""
    w = np.zeros(NUM_WEIGHTS, np.float32)
    w[W_TEXT] = cfg.text_weight
    w[W_VEC] = cfg.vector_weight
    w[W_HOT] = cfg.hotzone_weight
    w[W_RRF_SCALE] = cfg.rrf_scale
    w[W_BM25_DIV] = cfg.bm25_norm_divisor
    w[W_VEC_ONLY_PEN] = cfg.vector_only_penalty
    w[W_K1] = 1.2
    w[W_RRF_K] = float(cfg.rrf_k)
    w[W_VEC_BIAS] = cfg.vec_norm_bias
    w[W_VEC_SCALE] = cfg.vec_norm_scale
    w[W_LEG_ADAPT] = getattr(cfg, "leg_adaptive", 0.0)
    w[W_CONF_MARGIN] = getattr(cfg, "leg_conf_margin", 0.0)
    return w


def hybrid_query(
    sketch: torch.Tensor,      # (B, S) f32
    term_ids: torch.Tensor,    # (B, T) i32
    term_mask: torch.Tensor,   # (B, T) f32
    proj: torch.Tensor,        # (S, D) bf16
    E: torch.Tensor,           # (rows, D) bf16
    row_valid: torch.Tensor,   # (rows,) f32
    row2slot: torch.Tensor,    # (rows,) i32, -1 = tombstone
    row_scale: torch.Tensor,   # (rows,) f32 (ones for bf16)
    postings_doc: torch.Tensor,
    postings_impact: torch.Tensor,
    term_offsets: torch.Tensor,
    term_lengths: torch.Tensor,
    doc_mask: torch.Tensor,    # (num_slots,) | (B|U, num_slots) f32/uint8
    hot: torch.Tensor,         # (num_slots,) f32
    weights: torch.Tensor,     # (NUM_WEIGHTS,) f32
    mask_idx: torch.Tensor | None = None,  # (B,) i32 row of doc_mask
    *,
    k: int,
    rrf_cand: int,
    window: int,
    num_slots: int,
    chunk_agg: str = "max",
    rows_are_docs: bool = False,
    approx: bool = False,
    bm25_prefilter: int = 0,
    int8_corpus: bool = False,
    scan_block_rows: int = 0,
    packed_lexical: bool = False,
):
    """Returns (fused (B,k) f32, slots (B,k) i32, bm25_at (B,k), vec_at
    (B,k)), the reference's contract. `approx` selects nothing here: the
    top-C is exact, so a recall@10 of approx against exact is 1 by
    construction. `row_scale` is ones for the bf16 corpus and unused."""
    del row_scale, approx
    if scan_block_rows > 0:
        raise NotImplementedError("streaming blocked scan (scan_block_rows)")
    if int8_corpus:
        raise NotImplementedError("int8 corpus tier")
    if not rows_are_docs and chunk_agg != "max":
        raise NotImplementedError(f"chunk_agg={chunk_agg!r}")
    if weights.shape[-1] != NUM_WEIGHTS:
        raise ValueError(
            f"weights must have {NUM_WEIGHTS} slots, got {tuple(weights.shape)}")
    if mask_idx is not None:
        doc_mask = doc_mask[mask_idx.long()]
    dm = doc_mask.float()
    dm = dm if dm.dim() == 2 else dm[None, :]
    C = rrf_cand
    sink = num_slots

    # 1. embed queries
    q = dot_f32(sketch, proj.t())
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-9)

    # 2. vector leg: chunk scores -> doc scores -> top-C candidates
    srow = dot_f32(q, E)
    srow += ((row_valid - 1.0) * 1e30)[None, :]
    if rows_are_docs:
        sdoc = srow[:, :num_slots]
    else:
        seg = torch.where(row2slot < 0, sink, row2slot).long()
        sdoc = torch.full((srow.shape[0], num_slots + 1), -torch.inf,
                          dtype=srow.dtype, device=srow.device)
        sdoc.scatter_reduce_(1, seg[None, :].expand_as(srow), srow,
                             reduce="amax", include_self=True)
        del srow
        sdoc = sdoc[:, :num_slots]
    # filter pushdown before selection so filtered queries still fill C
    sdoc += (dm - 1.0) * 1e30
    vv, vi = top_k(sdoc, C)
    del sdoc
    return _fuse_candidates(
        term_ids, term_mask, postings_doc, postings_impact, term_offsets,
        term_lengths, dm, hot, weights, vv, vi.to(torch.int32),
        k=k, C=C, window=window, num_slots=num_slots,
        bm25_prefilter=bm25_prefilter, packed_lexical=packed_lexical,
    )


def hybrid_fuse_precomputed(
    term_ids, term_mask, postings_doc, postings_impact, term_offsets,
    term_lengths, doc_mask, hot, weights,
    vec_vals: torch.Tensor,   # (B, C) f32
    vec_slots: torch.Tensor,  # (B, C) i32, sink = absent
    mask_idx: torch.Tensor | None = None,
    *, k: int, rrf_cand: int, window: int, num_slots: int,
    bm25_prefilter: int = 0, packed_lexical: bool = False,
):
    """Fusion stages 3-5 with an externally computed vector candidate list;
    candidates outside the doc mask are dropped here."""
    if mask_idx is not None:
        doc_mask = doc_mask[mask_idx.long()]
    dm = doc_mask.float()
    dm = dm if dm.dim() == 2 else dm[None, :]
    sink = num_slots
    safe_v = vec_slots.long().clamp_max(sink - 1)
    if dm.shape[0] == 1:
        dm_at_v = dm[0][safe_v]
    else:
        dm_at_v = dm.gather(1, safe_v)
    vv = torch.where((dm_at_v > 0) & (vec_slots < sink), vec_vals, NEG)
    return _fuse_candidates(
        term_ids, term_mask, postings_doc, postings_impact, term_offsets,
        term_lengths, dm, hot, weights, vv, vec_slots,
        k=k, C=rrf_cand, window=window, num_slots=num_slots,
        bm25_prefilter=bm25_prefilter, packed_lexical=packed_lexical,
    )


def _segment_sum(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Running sum inside id-sorted segments (valid at segment ends)."""
    cs = prefix_sum(x)
    base = torch.where(first, cs - x, -torch.inf).cummax(dim=1).values
    return cs - base


def _fuse_candidates(
    term_ids, term_mask, postings_doc, postings_impact, term_offsets,
    term_lengths, dm, hot, weights, vv, vi_slots,
    *, k, C, window, num_slots, bm25_prefilter, packed_lexical=False,
):
    """Stages 3-5 (see yams_tpu/search/fusion.py:_fuse_candidates)."""
    sink = num_slots
    w = weights.float()

    # 3. lexical leg: top-C BM25 candidates (already rank-ordered)
    if packed_lexical:
        bm_ids, bm_scores = bm25_topk_candidates_packed(
            term_ids, term_mask, postings_doc, postings_impact,
            num_docs=num_slots, num_candidates=C, prefilter=bm25_prefilter,
        )
    else:
        bm_ids, bm_scores = bm25_topk_candidates(
            term_ids, term_mask, postings_doc, postings_impact, term_offsets,
            term_lengths, window=window, num_docs=num_slots,
            num_candidates=C, prefilter=bm25_prefilter,
        )

    # 4. candidate fusion — all O(C) per query
    ranks = torch.arange(C, dtype=torch.float32, device=vv.device)[None, :]
    rrf = 1.0 / (w[W_RRF_K] + ranks + 1.0)

    safe_ids = bm_ids.long().clamp_max(sink - 1)
    if dm.shape[0] == 1:
        dm_at_bm = dm[0][safe_ids]
    else:
        dm_at_bm = dm.gather(1, safe_ids)
    bm_ok = (bm_scores > 0) & (bm_ids < sink) & (dm_at_bm > 0) & (w[W_TEXT] > 0)
    bm_live = torch.where(bm_ok, bm_scores, 0.0)
    bm_qmax = bm_live.amax(dim=1, keepdim=True)
    bm_div = torch.where(w[W_BM25_DIV] > 0, w[W_BM25_DIV],
                         bm_qmax.clamp_min(1e-6))
    bm_norm = (bm_live / bm_div).clamp(0.0, 1.0)
    ids_bm = torch.where(bm_ok, bm_ids, sink)

    vec_ok = (vv > -1e29) & (w[W_VEC] > 0)
    vec_clip = ((vv + w[W_VEC_BIAS]) * w[W_VEC_SCALE]).clamp(0.0, 1.0)
    vec_live = torch.where(vec_ok, vec_clip, 0.0)
    vec_qmax = vec_live.amax(dim=1, keepdim=True)
    vec_norm = torch.where(w[W_BM25_DIV] > 0, vec_clip,
                           vec_live / vec_qmax.clamp_min(1e-6))

    # per-query leg-confidence adaptive weighting (full-window mean blended
    # with top-8 margin confidence)
    n_bm = bm_ok.sum(dim=1, keepdim=True).float()
    n_vec = vec_ok.sum(dim=1, keepdim=True).float()
    rel_l = (bm_live / bm_qmax.clamp_min(1e-6)).sum(dim=1, keepdim=True)
    rel_v = (vec_live / vec_qmax.clamp_min(1e-6)).sum(dim=1, keepdim=True)
    conf_l = torch.where(n_bm > 0, 1.0 - rel_l / n_bm.clamp_min(1.0), 0.0)
    conf_v = torch.where(n_vec > 0, 1.0 - rel_v / n_vec.clamp_min(1.0), 0.0)
    m_top = 8
    bm_top = bm_live[:, 1:m_top] / bm_qmax.clamp_min(1e-6)
    vec_top = vec_live[:, 1:m_top] / vec_qmax.clamp_min(1e-6)
    conf_l_m = torch.where(n_bm > 0, 1.0 - bm_top.mean(dim=1, keepdim=True), 0.0)
    conf_v_m = torch.where(n_vec > 0, 1.0 - vec_top.mean(dim=1, keepdim=True),
                           0.0)
    g = w[W_CONF_MARGIN].clamp(0.0, 1.0)
    conf_l = (1.0 - g) * conf_l + g * conf_l_m
    conf_v = (1.0 - g) * conf_v + g * conf_v_m
    mass_l = w[W_TEXT] * conf_l
    mass_v = w[W_VEC] * conf_v
    mass = mass_l + mass_v
    leg_sum = w[W_TEXT] + w[W_VEC]
    share_l = torch.where(mass > 1e-9, mass_l / mass.clamp_min(1e-9),
                          w[W_TEXT] / leg_sum.clamp_min(1e-9))
    a = w[W_LEG_ADAPT]
    wt_q = (1.0 - a) * w[W_TEXT] + a * leg_sum * share_l
    wv_q = (1.0 - a) * w[W_VEC] + a * leg_sum * (1.0 - share_l)

    val_bm = torch.where(bm_ok, wt_q * (bm_norm + w[W_RRF_SCALE] * rrf), 0.0)
    val_vec = torch.where(vec_ok, wv_q * (vec_norm + w[W_RRF_SCALE] * rrf), 0.0)
    ids_vec = torch.where(vec_ok, vi_slots, sink)

    zeros = torch.zeros_like(val_vec)
    ids = torch.cat([ids_bm, ids_vec], dim=1).long()           # (B, 2C)
    vals = torch.cat([val_bm, val_vec], dim=1)
    tflag = torch.cat([bm_ok.float(), zeros], dim=1)
    vflag = torch.cat([zeros, vec_ok.float()], dim=1)
    bm_raw = torch.cat([torch.where(bm_ok, bm_scores, 0.0), zeros], dim=1)

    # merge: sort candidates by doc id, segment-sum each doc's evidence
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    vals_s, t_s, v_s, bm_s = (x.gather(1, order)
                              for x in (vals, tflag, vflag, bm_raw))
    change = ids_s[:, 1:] != ids_s[:, :-1]
    edge = torch.ones_like(ids_s[:, :1], dtype=torch.bool)
    first = torch.cat([edge, change], dim=1)
    last = torch.cat([change, edge], dim=1)
    total = _segment_sum(vals_s, first)
    t_sum = _segment_sum(t_s, first)
    v_sum = _segment_sum(v_s, first)
    bm_sum = _segment_sum(bm_s, first)
    live = ids_s < sink
    total = torch.where((t_sum == 0) & (v_sum > 0),
                        total * w[W_VEC_ONLY_PEN], total)
    total = total + w[W_HOT] * hot[ids_s.clamp_max(sink - 1)] * live.float()
    total = torch.where(last & live, total, NEG)
    vals_k, pos = top_k(total, k)
    slots = ids_s.gather(1, pos)
    bm_at = bm_sum.gather(1, pos)
    # vec_at from the candidate lists (exact for every vector-leg doc;
    # lexical-only docs read -1)
    hit = slots[:, :, None] == vi_slots.long()[:, None, :]     # (B, k, C)
    vec_at = torch.where(hit, vv.clamp_min(-1.0)[:, None, :], -1.0).amax(dim=2)
    vals_k = torch.where(vals_k <= NEG / 2, NEG, vals_k)
    return vals_k, slots.to(torch.int32), bm_at, vec_at
