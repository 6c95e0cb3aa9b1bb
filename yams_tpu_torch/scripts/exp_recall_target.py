"""Recall against QPS of the approximate top-C on the vector leg, on the card.

Port of scripts/exp_recall_target.py, which sweeps lax.approx_max_k's
recall_target (0.99 / 0.95 / 0.9 / 0.8). That knob sizes approx_max_k's
binning stage and has no PyTorch counterpart. The port's approximate top-C
is K1's grouped-winner selection (ops/scan.py grouped_topk_pallas: at most
one hit per `group` consecutive rows, grouped_max_cuda on a card), and its
knob is the group width G, which sets the same thing: N / G bins.

bench.py's clustered corpus (N 1,000,448 x 768, 4,096 centres, sigma 0.35),
padded to a multiple of K1's 2,048-row layout with dead rows (valid 0), and
ITERS batches of B 1,024 unit queries are made on the device from one seed.
Each row runs the ITERS batches, timed as the best of three passes after a
warm-up (CUDA events on a card, the host clock on the CPU):

  exact       : dense_scores (dot_f32 + the dead rows' -1e30) + the exact
                top-C (select.top_k): the oracle and the baseline time
  K1 group=G  : grouped_topk_pallas at G in 16 / 64 / 256 / 1,024, with the
                leg's recall@10 against the oracle and the recall K1's
                contract allows (an oracle id is lost only to a
                higher-ranked one in its group of G rows)

then, for each of the reference's targets, the widest G whose measured
recall meets it ("none" where no G does).

    python -m yams_tpu_torch.scripts.exp_recall_target [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops.scan import dense_scores, grouped_topk_pallas
from ..ops.select import top_k
from ._common import batch_ms, device_name, recall
from .exp_flash_topk import clustered_inputs

K, BLOCK = 10, 2048
GROUPS = (16, 64, 256, 1024)
TARGETS = (0.99, 0.95, 0.9, 0.8)


def make_inputs(N: int, D: int, B: int, iters: int, n_clusters: int, sigma: float,
                device: str | torch.device, seed: int):
    """-> (queries (iters, B, D) f32, the corpus (N padded to BLOCK, D) bf16
    with zero pad rows, valid (rows,) f32: 0 on the pad rows)."""
    dev = resolve_device(device)
    qs, E = clustered_inputs(N, D, B, iters, n_clusters, sigma, dev, seed)
    pad = -N % BLOCK
    E = torch.cat([E, E.new_zeros(pad, D)])
    valid = torch.ones(N + pad, device=dev)
    valid[N:] = 0.0
    return qs, E, valid


def leg(q, E, valid, C: int, group: int | None):
    """One batch's top-K ids: the exact top-C (group None) or K1's."""
    if group is None:
        return top_k(dense_scores(q, E, valid), C)[1][:, :K]
    return grouped_topk_pallas(q, E, valid, C, block_rows=BLOCK, group=group)[1][:, :K]


def contract_recall(oracle: np.ndarray, group: int) -> float:
    """The recall@K that K1's contract allows against the oracle's ranked
    (rows, K) ids: a group of `group` rows keeps one winner, its best, so an
    oracle id is lost exactly when a higher-ranked oracle id lies in its
    group (and kept otherwise: every row scoring above it is in the list)."""
    g = oracle // group
    kept = [(g[:, :j] != g[:, j:j + 1]).all(axis=1) for j in range(g.shape[1])]
    return float(np.stack(kept, axis=1).mean())


def measure(qs, E, valid, device: torch.device, C: int = 32, groups=GROUPS) -> dict:
    """Time the oracle and each K1 width over qs (ITERS, B, D) and print
    the rows and the targets' lines."""
    iters, B = qs.shape[:2]
    out: dict = {"experiment": "exp_recall_target", "device": device_name(device),
                 "shape": {"N": int(valid.sum()), "rows": E.shape[0], "D": E.shape[1], "B": B,
                           "iters": iters, "C": C}, "rows": {}}
    oracle = None
    for group in (None, *groups):
        ms, res = batch_ms(lambda i: leg(qs[i], E, valid, C, group), iters, device, best_of=3)
        ids = torch.cat(res).cpu().numpy()
        oracle = ids if oracle is None else oracle
        r = {"ms": ms, "qps": B * 1e3 / ms, "recall10": recall(ids, oracle)}
        if group is None:
            out["rows"]["exact"] = r
            print(f"exact (dot_f32 + top-C, the oracle): {r['qps']:9.1f} qps  "
                  f"leg recall@10={r['recall10']:.4f}", flush=True)
        else:
            r["contract_recall10"] = contract_recall(oracle, group)
            out["rows"][f"k1_group{group}"] = {"group": group, "bins": E.shape[0] // group, **r}
            print(f"K1 group={group:5d} ({E.shape[0] // group:7d} bins): {r['qps']:9.1f} qps  "
                  f"leg recall@10={r['recall10']:.4f} (its contract allows "
                  f"{r['contract_recall10']:.4f})", flush=True)
    print("  (recall_target: lax.approx_max_k's knob has no PyTorch counterpart; K1's group "
          "width sets the same thing, its bin count)", flush=True)
    out["targets"] = {}
    for rt in TARGETS:
        met = [r for r in out["rows"].values() if "group" in r and r["recall10"] >= rt]
        best = max(met, key=lambda r: r["group"]) if met else None
        out["targets"][rt] = best and best["group"]
        print(f"recall_target={rt:4.2f}: " + (
            f"widest K1 group {best['group']} ({best['qps']:.1f} qps, leg recall@10="
            f"{best['recall10']:.4f})" if best else "none"), flush=True)
    return out


def run(N: int = 1_000_448, D: int = 768, B: int = 1024, iters: int = 8, C: int = 32,
        n_clusters: int = 4096, sigma: float = 0.35, groups=GROUPS,
        device: str | torch.device = "cuda", seed: int = 0) -> dict:
    qs, E, valid = make_inputs(N, D, B, iters, n_clusters, sigma, device, seed)
    return measure(qs, E, valid, E.device, C, groups)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
