"""The full hybrid query program, corpus-sharded over a device mesh.

Port of yams_tpu/parallel/sharded_hybrid.py (the multi-device form of
search/fusion.py; the reference's config 4 is 10M x 768-d over 8 chips):

  - the embedding matrix is row-sharded over the mesh; each shard computes
    its local KNN scores with the validity and doc-mask biases and its
    local top-C candidates, on its own device;
  - the candidate merge is hierarchical over the axes, innermost first:
    each level gathers the previous level's C winners of a group in mesh
    order and keeps a top-C, on the group's first device;
  - a max-dedup by doc slot: chunk rows of one doc may surface from several
    shards, and fusion sums leg contributions, so the vector list carries
    each slot once at its best chunk score (chunk_agg "max" exactly);
  - the lexical leg on the replicated postings and the candidate fusion.

Departures from the reference, each with the same result:
  - the replicated stages run once, on the mesh's lead device: the query
    embed (which each shard then reads), the lexical leg and the fusion.
    The reference computes them redundantly on every shard;
  - the fusion is search/fusion.py's `_fuse_candidates`: the reference's
    inline copy here is the same math (its final NEG clamp is a no-op on
    the merged list), so the port keeps one copy;
  - the dedup's two-key sort (slot, then descending score) is two stable
    sorts, torch.sort taking one key;
  - the query norm sums its squares in f64 (fusion._row_norm), as the
    port's single-device program does.

Chunk placement need not be doc-affine: the dedup keeps a doc's best chunk
whichever shards its rows sit on. Sum and topk_avg aggregation are not
expressible this way; the engine serves those on one device.
"""

from __future__ import annotations

import torch

from ..ops.scan import dot_f32, int8_product, quantize_rows
from ..ops.select import top_k
from ..search.fusion import NEG, _fuse_candidates, _row_norm
from .mesh import Mesh, Replicas, all_gather, shard_grid, shard_rows


def sharded_hybrid_query(
    mesh: Mesh,
    sketch: torch.Tensor,      # (B, S) replicated
    term_ids: torch.Tensor,    # (B, T) replicated
    term_mask: torch.Tensor,   # (B, T) replicated
    proj: torch.Tensor,        # (S, D) replicated bf16
    E,                         # (rows, D) row-sharded, bf16 or int8
    row_valid,                 # (rows,) row-sharded
    row2slot,                  # (rows,) row-sharded: GLOBAL doc slots
    row_scale,                 # (rows,) row-sharded (ones for bf16)
    postings_doc: torch.Tensor,  # replicated lexical arrays
    postings_impact: torch.Tensor,
    term_offsets: torch.Tensor,
    term_lengths: torch.Tensor,
    doc_mask: torch.Tensor,    # (num_slots,) | (B|U, num_slots) f32 or uint8
    hot: torch.Tensor,         # (num_slots,) replicated
    weights: torch.Tensor,
    mask_idx: torch.Tensor | None = None,  # (B,) i32: doc_mask row a query
    *,
    k: int,
    rrf_cand: int,
    window: int,
    num_slots: int,
    int8_corpus: bool = False,
    axis: str | tuple[str, ...] = "d",
    packed_lexical: bool = False,
    bm25_prefilter: int = 0,
):
    """Returns (fused (B,k), slots (B,k) i32, bm25_at (B,k), vec_at (B,k))
    on the mesh's lead device: fusion.hybrid_query's contract, so the
    engine serves either path.

    `axis` may be a tuple ordered outermost first, e.g. ("dcn", "ici"):
    rows shard over both, and the merge runs inside each group of the inner
    axis first, then across groups. Sharded arguments are one tensor or a
    list of per-shard parts (parallel.mesh.shard_rows)."""
    q, qscale = embed_queries(sketch.to(mesh.lead), proj.to(mesh.lead), int8_corpus)
    cands = local_candidates(mesh, q, qscale, E, row_valid, row2slot, row_scale,
                             doc_mask, mask_idx, C=rrf_cand, num_slots=num_slots,
                             int8_corpus=int8_corpus, axis=axis)
    vv, vslots = merge_candidates(mesh, cands, C=rrf_cand, num_slots=num_slots, axis=axis)
    lead = mesh.lead
    return _fuse_candidates(
        term_ids.to(lead), term_mask.to(lead), postings_doc.to(lead),
        postings_impact.to(lead), term_offsets.to(lead), term_lengths.to(lead),
        doc_mask.to(lead), None if mask_idx is None else mask_idx.to(lead),
        hot.to(lead), weights.to(lead), vv, vslots,
        k=k, C=rrf_cand, window=window, num_slots=num_slots,
        bm25_prefilter=bm25_prefilter, packed_lexical=packed_lexical,
    )


def embed_queries(sketch: torch.Tensor, proj: torch.Tensor, int8_corpus: bool):
    """Stage 1, once: the L2-normalized f32 queries and None, or for an int8
    corpus their int8 codes and per-query scales."""
    q = dot_f32(sketch, proj.t())
    q = q / _row_norm(q).clamp_min(1e-9)
    return quantize_rows(q) if int8_corpus else (q, None)


def local_candidates(mesh: Mesh, q: torch.Tensor, qscale: torch.Tensor | None,
                     E, row_valid, row2slot, row_scale, doc_mask: torch.Tensor,
                     mask_idx: torch.Tensor | None, *, C: int, num_slots: int,
                     int8_corpus: bool, axis) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Stage 2 on every shard, each on its device: the scores of its rows
    (int8 codes when int8_corpus, with q the int8 queries and qscale their
    scales), the validity bias, the doc mask at each row's slot (a
    tombstoned row reads 0), and the local top-C as (values, global slots;
    sink where a candidate is dead). A shard with fewer than C rows pads its
    list with (NEG, sink)."""
    sink = num_slots
    cols = [shard_rows(mesh, a, axis) for a in (E, row_valid, row2slot, row_scale)]
    q_rep, qs_rep = Replicas(q), Replicas(qscale)
    dm_rep, idx_rep = Replicas(doc_mask), Replicas(mask_idx)
    out = []
    for e, v, r2s, rs in zip(*cols):
        dev = e.device
        if int8_corpus:
            s = int8_product(q_rep.on(dev), qs_rep.on(dev), e, rs)
        else:
            s = dot_f32(q_rep.on(dev), e)
        s += ((v - 1.0) * 1e30)[None, :]
        dm = dm_rep.on(dev)
        r_idx = r2s.long().clamp(0, sink - 1)
        dm_rows = (dm[r_idx] if dm.dim() == 1 else dm[:, r_idx]).float()
        if mask_idx is not None:
            dm_rows = dm_rows[idx_rep.on(dev).long()]
        dm_rows = dm_rows * torch.where(r2s < 0, 0.0, 1.0)
        s += (dm_rows - 1.0) * 1e30
        del dm_rows
        c_loc = min(C, s.shape[1])
        lv, li = top_k(s, c_loc)
        del s
        lslots = torch.where(lv > -1e29, r2s[li].long(), sink)
        if c_loc < C:
            pad = C - c_loc
            lv = torch.cat([lv, lv.new_full((lv.shape[0], pad), NEG)], dim=1)
            lslots = torch.cat([lslots, lslots.new_full((lslots.shape[0], pad), sink)],
                               dim=1)
        out.append((lv, lslots))
    return out


def merge_candidates(mesh: Mesh, cands: list[tuple[torch.Tensor, torch.Tensor]], *,
                     C: int, num_slots: int, axis) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 3: the hierarchical merge, innermost axis first: each group of
    consecutive shards (the inner axis's size) gathers its C winners in
    mesh order on its first device and keeps a top-C; then the max-dedup by
    slot and a top-C again, on the lead device. -> (values (B, C) f32,
    slots (B, C) i32)."""
    level = cands
    for size in reversed(shard_grid(mesh, axis).shape):
        merged = []
        for lo in range(0, len(level), size):
            group = level[lo:lo + size]
            dev = group[0][0].device
            all_v = all_gather([g[0] for g in group], device=dev)
            all_s = all_gather([g[1] for g in group], device=dev)
            vv, pos = top_k(all_v, C)
            merged.append((vv, all_s.gather(1, pos)))
        level = merged
    (vv, vslots), = level
    return dedup_slots(vv.to(mesh.lead), vslots.to(mesh.lead), C=C, sink=num_slots)


def dedup_slots(vv: torch.Tensor, vslots: torch.Tensor, *, C: int, sink: int):
    """Keep each slot once at its max score: order by (slot, -score) with
    two stable sorts, blank every repeat of a slot to (NEG, sink), then a
    top-C restores the descending rank order."""
    by_val = torch.argsort(-vv, dim=1, stable=True)
    s1 = vslots.gather(1, by_val)
    by_slot = torch.argsort(s1, dim=1, stable=True)
    order = by_val.gather(1, by_slot)
    s_s, v_s = vslots.gather(1, order), vv.gather(1, order)
    first = torch.ones_like(s_s, dtype=torch.bool)
    first[:, 1:] = s_s[:, 1:] != s_s[:, :-1]
    v_s = torch.where(first, v_s, NEG)
    s_s = torch.where(first, s_s, sink)
    v_o, pos = top_k(v_s, C)
    return v_o, s_s.gather(1, pos).to(torch.int32)
