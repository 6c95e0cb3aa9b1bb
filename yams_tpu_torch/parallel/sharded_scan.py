"""Sharded KNN and hybrid scoring over a device mesh.

Port of yams_tpu/parallel/sharded_scan.py. Each shard scans its rows with
the port's single-device scan (exact_topk_scan, int8_topk_scan,
pq_adc_topk: torch operations, no hand kernel, as the reference's shards
run XLA) on its own device; the k-wide candidate lists are gathered in
mesh order on the lead device and one top-k merges them, so ties keep
lax.top_k's order (the earlier shard, then the lower column).

Sharded arguments are one tensor split into equal row parts, or a list of
parts, one a shard (parallel.mesh.shard_rows); replicated arguments are
one tensor, copied to each device that needs it. Results are on the
mesh's lead device.
"""

from __future__ import annotations

import torch

from ..ops.scan import dot_f32, exact_topk_scan, int8_topk_scan
from ..ops.select import top_k
from .mesh import Mesh, Replicas, all_gather, pmax, shard_rows


def _merge_topk(vals: list[torch.Tensor], idx: list[torch.Tensor], *, k: int,
                rows_local: int, device: torch.device):
    """Per-shard -> global candidate merge (the reference's
    _ici_merge_topk): offset live local rows by the shard's base (the -1
    sentinels stay), gather the k-wide lists in mesh order, exact top-k on
    the (B, k * shards) merge."""
    idx = [torch.where(i >= 0, i + s * rows_local, i) for s, i in enumerate(idx)]
    out_v, pos = top_k(all_gather(vals, device=device), k)
    return out_v, all_gather(idx, device=device).gather(1, pos)


def shard_corpus(mesh: Mesh, corpus: torch.Tensor, valid: torch.Tensor,
                 axis: str = "d"):
    """Place (N, D) corpus + (N,) valid row-sharded over the mesh."""
    return shard_rows(mesh, corpus, axis), shard_rows(mesh, valid, axis)


def _sharded(mesh, axis, local, sharded_args, replicated, k):
    """Run local(shard, *replicated-on-its-device, *its-parts) -> (vals,
    local rows) on every shard, then merge."""
    cols = [shard_rows(mesh, a, axis) for a in sharded_args]
    reps = [Replicas(r) for r in replicated]
    vals, idx = [], []
    for s, parts in enumerate(zip(*cols)):
        dev = parts[0].device
        v, i = local(*(r.on(dev) for r in reps), *parts)
        vals.append(v)
        idx.append(i)
    return _merge_topk(vals, idx, k=k, rows_local=cols[0][0].shape[0],
                       device=mesh.lead)


def sharded_topk(mesh: Mesh, queries: torch.Tensor, corpus, valid, k: int,
                 block_rows: int = 2048, axis: str = "d"):
    """Per-shard streaming top-k, then gather(k * shards) + final top-k.

    Returns (values (B, k) f32, global rows (B, k) i32) on the lead device."""
    return _sharded(
        mesh, axis,
        lambda q, e, v: exact_topk_scan(q, e, v, k=k, block_rows=block_rows),
        (corpus, valid), (queries,), k)


def sharded_int8_topk(mesh: Mesh, queries: torch.Tensor, corpus_q, corpus_scale,
                      valid, k: int, block_rows: int = 4096, axis: str = "d"):
    """The int8 tier over the mesh (the reference's config 4: 10M x 768-d
    int8 over 8 devices): each shard's int8 scan, then the merge."""
    return _sharded(
        mesh, axis,
        lambda q, cq, cs, v: int8_topk_scan(q, cq, cs, v, k=k, block_rows=block_rows),
        (corpus_q, corpus_scale, valid), (queries,), k)


def sharded_pq_topk(mesh: Mesh, queries: torch.Tensor, codes,
                    centroids: torch.Tensor, valid, k: int,
                    block_rows: int = 8192, packed4: bool = False,
                    group: int = 1, axis: str = "d"):
    """The PQ capacity tier over the mesh: each shard's ADC scan
    (ops.pq.pq_adc_topk), then the merge. group > 1 keeps one candidate per
    `group`-row window; a window never straddles a shard (the shard's rows
    must be a multiple of `group`)."""
    from ..ops.pq import pq_adc_topk

    parts = shard_rows(mesh, codes, axis)
    if parts[0].shape[0] % group:
        raise ValueError(f"{parts[0].shape[0]} rows a shard do not split into "
                         f"windows of {group}")
    return _sharded(
        mesh, axis,
        lambda q, cent, c, v: pq_adc_topk(q, c, cent, v, k=k, block_rows=block_rows,
                                          packed4=packed4, group=group),
        (parts, valid), (queries, centroids), k)


def sharded_hybrid_scores(mesh: Mesh, queries: torch.Tensor, corpus, row_valid,
                          row2slot, bm25_local: torch.Tensor, num_slots: int,
                          k: int, axis: str = "d", text_weight: float = 0.70,
                          vector_weight: float = 0.30):
    """Sharded vector leg + replicated lexical leg -> fused doc top-k.

    Each shard segment-reduces its chunk scores onto the global doc-slot
    space; a pmax merges the partial doc maxima across shards (chunks of one
    doc may live on different shards), then fusion and top-k run on the
    lead device."""
    cols = [shard_rows(mesh, a, axis) for a in (corpus, row_valid, row2slot)]
    q_rep = Replicas(queries)
    partial = []
    for e, v, r2s in zip(*cols):
        q = q_rep.on(e.device)
        s = dot_f32(q, e)
        s += ((v - 1.0) * 1e30)[None, :]
        seg = torch.where(r2s < 0, num_slots, r2s).long()
        sdoc = torch.full((q.shape[0], num_slots + 1), -torch.inf, device=e.device)
        sdoc.scatter_reduce_(1, seg[None, :].expand_as(s), s, reduce="amax")
        partial.append(sdoc[:, :num_slots])
    sdoc = pmax(partial, device=mesh.lead)
    bm = bm25_local.to(mesh.lead)
    # cosine as a [0,1] similarity, negatives floored
    vec_norm = sdoc.clamp(0.0, 1.0)
    bm_norm = (bm / 25.0).clamp(0.0, 1.0)
    fused = text_weight * bm_norm + vector_weight * vec_norm
    fused = torch.where((bm > 0) | (sdoc > -1e29), fused, -1e30)
    vals, slots = top_k(fused, k)
    return vals, slots.to(torch.int32)
