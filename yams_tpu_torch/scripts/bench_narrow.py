"""The narrow mechanism's payoff: the routed gather scan against the full scan.

Port of scripts/bench_narrow.py. A clustered corpus (default 1,000,448 x
768 bf16: 4,096 unit centers, each row a center plus uniform noise whose
vector norm is ~sigma 0.35, rows L2-normalized, a row's center by a
multiplicative hash of its index) and, per batch size, queries near random
centers are made on the device from a torch generator seeded by --seed (not
JAX's PRNG: the numbers are this script's own, never the reference's data).
Each batch is routed to its top-4 clusters by centroid similarity (the true
synthetic structure: the mechanism's ceiling, not routing quality), and the
vector leg runs three ways, top-C 32:

  full    dense_scores (dot_f32, the port's vector leg) over all N rows and
          the tie-exact top-C (select.top_k), one corpus read for the batch;
  narrow  routed_gather_topk: each query's routed rows gathered into a
          (B, R, D) buffer and scored alone;
  contig  the cluster-contiguous variant: rows re-packed by cluster, each
          query scoring top_c slices of 512 rows of the sorted layout.

For each B it prints one JSON line: QPS of each (a synced call, best of 8),
device ms (CUDA events; on the CPU the wall ms), recall@10 against the exact
full scan, the routed rows R, and routed_gather_topk's bytes bound (B*R*D*2
gathered).

    python -m yams_tpu_torch.scripts.bench_narrow [--n 1000448] [--clusters 4096]
        [--batches 1,8,32,128] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.scan import dense_scores, routed_gather_topk
from ..ops.select import top_k
from ._common import cuda_ms, recall, sync

PEAK_BYTES = 3.35e12   # B/s, H100 SXM HBM3 (NVIDIA's data sheet)
SLICE = 512            # rows a contig slice reads: >= any cluster at 1M / 4,096


def clustered(N: int, D: int, n_clusters: int, sigma: float, gen: torch.Generator,
              dev: torch.device, chunk: int = 1 << 17):
    """(centers (n_clusters, D) f32, E (N, D) bf16 unit rows, assign (N,) int64)."""
    centers = torch.randn(n_clusters, D, generator=gen, device=dev)
    centers /= centers.norm(dim=1, keepdim=True)
    ar = torch.arange(N, device=dev, dtype=torch.int64)
    assign = (((ar * 2654435761) & 0xFFFFFFFF) >> 7) % n_clusters
    E = torch.empty(N, D, device=dev, dtype=torch.bfloat16)
    scale = sigma / (D / 3.0) ** 0.5        # uniform noise of vector norm ~sigma
    for lo in range(0, N, chunk):
        hi = min(N, lo + chunk)
        noise = torch.rand(hi - lo, D, generator=gen, device=dev) * 2.0 - 1.0
        e = centers[assign[lo:hi]] + scale * noise
        E[lo:hi] = (e / e.norm(dim=1, keepdim=True).clamp_min(1e-9)).to(torch.bfloat16)
    return centers, E, assign


def contig_scan(q, E_sorted, c_starts, c_sizes, k: int):
    """top_c slices of SLICE rows of the cluster-sorted layout per query ->
    (values (B, k), rows of the SORTED layout (B, k))."""
    B, top_c = c_starts.shape
    st = torch.clamp(c_starts, max=E_sorted.shape[0] - SLICE)
    pos = torch.arange(SLICE, device=q.device)
    rows = (st[:, :, None] + pos).reshape(B, -1)                  # (B, top_c*SLICE)
    blocks = E_sorted.index_select(0, rows.reshape(-1)).reshape(B, rows.shape[1], -1)
    qb = q.to(torch.bfloat16)[:, :, None]
    if q.device.type == "cuda":
        s = torch.bmm(blocks, qb, out_dtype=torch.float32)[:, :, 0]
    else:
        s = torch.bmm(blocks.float(), qb.float())[:, :, 0]
    ok = (pos[None, None, :] < c_sizes[:, :, None]).reshape(B, -1)
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    v, p = top_k(s, k)
    return v, rows.gather(1, p)


def run(N: int = 1_000_448, D: int = 768, n_clusters: int = 4096, top_c: int = 4,
        K: int = 10, C: int = 32, sigma: float = 0.35, batches=(1, 8, 32, 128),
        seed: int = 0, device: str | torch.device = "cuda", log=print) -> list[dict]:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    centers, E, assign = clustered(N, D, n_clusters, sigma, gen, dev)
    valid = torch.ones(N, device=dev)
    assign_np = assign.cpu().numpy()
    order = np.argsort(assign_np, kind="stable")
    sa = assign_np[order]
    starts = np.searchsorted(sa, np.arange(n_clusters))
    ends = np.searchsorted(sa, np.arange(n_clusters), side="right")
    order_dev = torch.from_numpy(order).to(dev)
    E_sorted = E.index_select(0, order_dev)
    centers_np = centers.cpu().numpy()

    def timed(fn, n: int = 8):
        out = fn()
        sync(dev)
        best = np.inf
        for _ in range(n):
            t = time.perf_counter()
            out = fn()
            sync(dev)
            best = min(best, time.perf_counter() - t)
        return out, best

    def device_ms(fn, reps: int = 8) -> float:
        if dev.type == "cuda":
            return cuda_ms(fn, reps)
        return timed(fn, reps)[1] * 1e3

    rows_out = []
    rng = np.random.default_rng(seed + 7)
    for B in batches:
        qc = rng.integers(0, n_clusters, size=B)
        q = centers_np[qc] + 0.2 * rng.standard_normal((B, D)).astype(np.float32) / np.sqrt(D)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        qd = torch.from_numpy(q.astype(np.float32)).to(dev)
        # routing: top-4 clusters by centroid similarity (host, tiny)
        routed = np.argsort(-(q @ centers_np.T), axis=1, kind="stable")[:, :top_c]
        rowlists = [np.concatenate([order[starts[c]:ends[c]] for c in routed[i]])
                    for i in range(B)]
        R = 1 << (max(len(r) for r in rowlists) - 1).bit_length()
        row_idx = np.zeros((B, R), np.int32)
        row_ok = np.zeros((B, R), np.float32)
        for i, rl in enumerate(rowlists):
            row_idx[i, :len(rl)] = rl
            row_ok[i, :len(rl)] = 1.0
        ri, ro = torch.from_numpy(row_idx).to(dev), torch.from_numpy(row_ok).to(dev)
        c_st = torch.from_numpy(starts[routed]).to(dev)
        c_sz = torch.from_numpy((ends - starts)[routed]).to(dev)

        oracle = top_k(dense_scores(qd, E, valid), K)[1].cpu().numpy()

        def full():
            return top_k(dense_scores(qd, E, valid), C)

        def narrow():
            return routed_gather_topk(qd, E, ri, ro, C)

        def contig():
            return contig_scan(qd, E_sorted, c_st, c_sz, C)

        (_, fi), t_full = timed(full)
        (_, ni), t_nar = timed(narrow)
        (_, ci), t_con = timed(contig)
        full_ms, nar_ms, con_ms = device_ms(full), device_ms(narrow), device_ms(contig)
        ci_rows = order[ci.cpu().numpy()]
        gather_bytes = B * R * D * 2
        row = {
            "B": B, "routed_rows": int(R),
            "full_qps": B / t_full, "narrow_qps": B / t_nar, "contig_qps": B / t_con,
            "full_dev_ms": full_ms, "narrow_dev_ms": nar_ms, "contig_dev_ms": con_ms,
            "dev_speedup": full_ms / nar_ms, "contig_dev_speedup": full_ms / con_ms,
            "full_recall10": recall(fi.cpu().numpy()[:, :K], oracle),
            "narrow_recall10": recall(ni.cpu().numpy()[:, :K], oracle),
            "contig_recall10": recall(ci_rows[:, :K], oracle),
            "narrow_bound_bytes": gather_bytes,
            "narrow_bound_ms": gather_bytes / PEAK_BYTES * 1e3,
        }
        rows_out.append(row)
        log(json.dumps(row))
    return rows_out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1_000_448)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--clusters", type=int, default=4096)
    p.add_argument("--batches", default="1,8,32,128")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    run(N=a.n, D=a.dim, n_clusters=a.clusters,
        batches=tuple(int(b) for b in a.batches.split(",")), seed=a.seed, device=a.device)


if __name__ == "__main__":
    main()
