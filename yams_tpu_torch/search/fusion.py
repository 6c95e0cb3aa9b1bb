"""The hybrid query: embed ∥ BM25 ∥ KNN -> fuse -> top-k, on torch tensors.

Port of yams_tpu/search/fusion.py. Stages:

  1. query embed: sketch @ proj (bf16 operands, f32 result) -> L2 normalize;
  2. vector leg, one of:
     - materialized: the (B, rows) scores, bf16 (`dot_f32`) or int8
       (`int8_corpus`: the query quantized on the device, int8 x int8 with
       int32 sums), then chunk -> doc aggregation (`rows_are_docs`, or
       `chunk_agg` max | sum | topk_avg | weighted_topk_avg), filter
       pushdown, top-C;
     - streaming (`scan_block_rows` with `rows_are_docs`): per block of
       rows the scores, the validity and doc-mask biases and a top-C, ids
       offset by the block's first row; the candidates merge with a carry
       that starts at (-1e30, sink) and comes first. No (B, rows) buffer.
  3. lexical leg: BM25 top-C candidates (ops.bm25);
  4. candidate fusion over the 2C candidates: weighted evidence + RRF,
     adaptive leg weights, vector-only penalty, hotzone boost;
  5. exact top-k over the merged candidates.

Differences from the reference, all deliberate:
- the query's L2 norm sums its squares in f64 (`_row_norm`), so it is the
  same on the card and on the CPU;
- "approx" selection is exact (lax.approx_max_k is exact off the TPU as
  well, so CPU parity is exact);
- the streaming scan merges every block's top-C in one top-C at the end
  instead of one merge a block: with the carry first and ties to the lower
  column that is the reference's sequential merge, ids and sink ids
  included. A per-query mask is sliced by columns per block, never
  expanded to (B, rows);
- lax.sort(num_keys=1) in the merge becomes a stable sort by id + gathers;
  lax.top_k and jnp.cumsum become ops.select's top_k / prefix_sum, which
  keep the reference's tie order and summation order;
- the (B, rows) score matrix is updated in place for the biases, the
  chunk aggregations and the doc mask, so at most two (B, rows)-sized f32
  buffers are live (scores and doc scores);
- the doc mask is read at the candidates by (row of mask_idx, id) pairs,
  so per-query filter rows are expanded to (B, num_slots) only where the
  materialized path adds them to the doc scores.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bm25 import bm25_topk_candidates, bm25_topk_candidates_packed
from ..ops.scan import dot_f32, int8_product, quantize_rows
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
    E: torch.Tensor,           # (rows, D) bf16, or int8 with int8_corpus
    row_valid: torch.Tensor,   # (rows,) f32
    row2slot: torch.Tensor,    # (rows,) i32, -1 = tombstone
    row_scale: torch.Tensor,   # (rows,) f32: int8 dequant scales (ones for bf16)
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
    construction. On the streaming path the doc mask is indexed by row, so
    it must have `rows` columns (the engine pads it)."""
    del approx
    if weights.shape[-1] != NUM_WEIGHTS:
        raise ValueError(
            f"weights must have {NUM_WEIGHTS} slots, got {tuple(weights.shape)}")
    if chunk_agg not in ("max", "sum", "topk_avg", "weighted_topk_avg"):
        raise ValueError(f"chunk_agg={chunk_agg!r}")
    C = rrf_cand
    sink = num_slots

    # 1. embed queries
    q = dot_f32(sketch, proj.t())
    q = q / _row_norm(q).clamp_min(1e-9)
    q8 = qscale = None
    if int8_corpus:
        q8, qscale = quantize_rows(q)

    def scores(lo, hi):
        """(B, hi - lo) f32 scores of rows lo..hi with the validity bias."""
        if int8_corpus:
            s = int8_product(q8, qscale, E[lo:hi], row_scale[lo:hi])
        else:
            s = dot_f32(q, E[lo:hi])
        s += ((row_valid[lo:hi] - 1.0) * 1e30)[None, :]
        return s

    # 2. vector leg -> top-C candidates (doc slots)
    if scan_block_rows > 0 and rows_are_docs:
        vv, vi = _streaming_top_c(scores, E.shape[0], q.shape[0], doc_mask,
                                  mask_idx, C, sink, scan_block_rows)
    else:
        srow = scores(0, E.shape[0])
        if rows_are_docs:
            sdoc = srow[:, :num_slots]
        else:
            sdoc = _aggregate_chunks(srow, row2slot, num_slots, chunk_agg)
        del srow
        # filter pushdown before selection so filtered queries still fill C
        bias = (doc_mask if mask_idx is None else doc_mask[mask_idx.long()]
                ).to(torch.float32, copy=True)
        sdoc += bias.sub_(1.0).mul_(1e30)
        del bias
        vv, vi = top_k(sdoc, C)
        del sdoc
    return _fuse_candidates(
        term_ids, term_mask, postings_doc, postings_impact, term_offsets,
        term_lengths, doc_mask, mask_idx, hot, weights, vv, vi.to(torch.int32),
        k=k, C=C, window=window, num_slots=num_slots,
        bm25_prefilter=bm25_prefilter, packed_lexical=packed_lexical,
    )


def _row_norm(q: torch.Tensor) -> torch.Tensor:
    """(B, 1) f32 L2 norms whose last bit does not depend on the summation
    order: the squares are summed in f64 (exact to far below an f32 ulp)
    and rounded once. A sketch query often has a coordinate at exactly half
    its largest, which the int8 tier quantizes to 63.5 and rounds by the
    last bit of q; an f32 sum in the card's order and another in the CPU's
    would round it to 63 on one and 64 on the other."""
    return q.double().square().sum(dim=-1, keepdim=True).float().sqrt()


def _streaming_top_c(scores, rows: int, B: int, doc_mask, mask_idx, C: int,
                     sink: int, block: int):
    """The streaming blocked scan's vector leg: for each block of `block`
    rows the biased scores and their top-C, ids offset by the block's first
    row; then one top-C over [carry (-1e30, sink), block 0's, block 1's,
    ...], which with ties to the lower column is the reference's merge of
    each block into the carry, carry first. So where fewer than C rows are
    live the carry's sink ids stay (a masked row scores -1e30 too)."""
    if rows % block:
        raise ValueError(f"rows={rows} % scan_block_rows={block} != 0")
    if doc_mask.shape[-1] != rows:
        raise ValueError(f"the streaming scan indexes the doc mask by row: "
                         f"{doc_mask.shape[-1]} columns for {rows} rows")
    dev = doc_mask.device
    cand_v = [torch.full((B, C), NEG, dtype=torch.float32, device=dev)]
    cand_i = [torch.full((B, C), sink, dtype=torch.int64, device=dev)]
    rows_of = mask_idx.long() if mask_idx is not None else None
    for lo in range(0, rows, block):
        hi = lo + block
        s = scores(lo, hi)
        m = doc_mask[..., lo:hi]
        if rows_of is not None:
            m = m[rows_of]
        s += (m.float() - 1.0) * 1e30
        bv, bi = top_k(s, C)
        del s
        cand_v.append(bv)
        cand_i.append(bi + lo)
    vv, pos = top_k(torch.cat(cand_v, dim=1), C)
    return vv, torch.cat(cand_i, dim=1).gather(1, pos)


_AGG_ROWS = 1 << 16   # score columns a chunk of the knock-out pass takes


def _aggregate_chunks(srow: torch.Tensor, row2slot: torch.Tensor, num_slots: int,
                      chunk_agg: str) -> torch.Tensor:
    """Chunk -> doc scores (B, num_slots) from the (B, rows) chunk scores,
    the reference's segment reductions (tombstones go to the sink segment,
    empty docs read -inf, or -1e30 for "sum"). `srow` is overwritten.

    - max: segment max;
    - sum: segment sum of max(s, 0); docs without a positive sum -> -1e30;
    - topk_avg / weighted_topk_avg: the max m1 and a second segment max m2
      with every chunk that reaches its doc's max knocked out (two chunks
      tied at the max both go); a doc with no other chunk takes m2 = m1;
      then (m1 + m2) / 2, or (m1 + m2 / 2) / 1.5."""
    sink = num_slots
    seg = torch.where(row2slot < 0, sink, row2slot).long()
    B = srow.shape[0]

    def segment(reduce: str, init: float) -> torch.Tensor:
        out = torch.full((B, num_slots + 1), init, dtype=srow.dtype, device=srow.device)
        return out.scatter_reduce_(1, seg[None, :].expand_as(srow), srow,
                                   reduce=reduce, include_self=True)

    if chunk_agg == "sum":
        srow.clamp_min_(0.0)
        sdoc = segment("sum", 0.0)
        sdoc.masked_fill_(sdoc <= 0, NEG)
    elif chunk_agg == "max":
        sdoc = segment("amax", -torch.inf)
    else:
        m1 = segment("amax", -torch.inf)
        for lo in range(0, srow.shape[1], _AGG_ROWS):
            part = srow[:, lo:lo + _AGG_ROWS]
            part.masked_fill_(part >= m1[:, seg[lo:lo + _AGG_ROWS]], NEG)
        m2 = segment("amax", -torch.inf)
        torch.where(m2 <= NEG / 2, m1, m2, out=m2)       # single-chunk docs
        # in place, each op rounding as the reference's expression does (a
        # tensor divisor: a Python one is a reciprocal multiply on a card)
        if chunk_agg == "topk_avg":
            sdoc = m1.add_(m2).mul_(0.5)
        else:
            sdoc = m1.add_(m2.mul_(0.5)).div_(m1.new_tensor(1.5))
    return sdoc[:, :num_slots]


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
    sink = num_slots
    dm_at_v = _mask_at(doc_mask, mask_idx, vec_slots.long().clamp_max(sink - 1))
    vv = torch.where((dm_at_v > 0) & (vec_slots < sink), vec_vals, NEG)
    return _fuse_candidates(
        term_ids, term_mask, postings_doc, postings_impact, term_offsets,
        term_lengths, doc_mask, mask_idx, hot, weights, vv, vec_slots,
        k=k, C=rrf_cand, window=window, num_slots=num_slots,
        bm25_prefilter=bm25_prefilter, packed_lexical=packed_lexical,
    )


def _mask_at(doc_mask: torch.Tensor, mask_idx: torch.Tensor | None,
             ids: torch.Tensor) -> torch.Tensor:
    """The doc mask at (query, id) pairs, (B, n) f32: a shared mask (1-D or
    one row) is indexed by id, per-query rows by (row of mask_idx, id), so
    the rows are never expanded to (B, num_slots)."""
    if doc_mask.dim() == 1 or (doc_mask.shape[0] == 1 and mask_idx is None):
        return doc_mask.reshape(-1)[ids].float()
    if mask_idx is None:
        return doc_mask.gather(1, ids).float()
    return doc_mask[mask_idx.long()[:, None], ids].float()


def _segment_sum(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Running sum inside id-sorted segments (valid at segment ends)."""
    cs = prefix_sum(x)
    base = torch.where(first, cs - x, -torch.inf).cummax(dim=1).values
    return cs - base


def _fuse_candidates(
    term_ids, term_mask, postings_doc, postings_impact, term_offsets,
    term_lengths, doc_mask, mask_idx, hot, weights, vv, vi_slots,
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

    dm_at_bm = _mask_at(doc_mask, mask_idx, bm_ids.long().clamp_max(sink - 1))
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
