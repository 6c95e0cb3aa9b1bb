"""grouped_topk_pallas (K1) against the matmul + top-C path at 1M x 768.

Port of scripts/profile_grouped.py. A unit-normal bf16 corpus of N rows
(rounded up to the block) and `iters` batches of B unit queries are made on
the device from one seed. Each batch goes through

  - the kernel path: grouped_topk_pallas (one winner per `group` rows,
    fused with the product; K1 on a card), top-C, its first 10;
  - the matmul + top-C path: dense_scores (dot_f32, the port's vector leg)
    and the exact tie-ordered select.top_k, its first 10.

It reports the QPS of each (median of `windows` timed windows of `iters`
batches, every window listed), recall@10 of each against the exact top-10
of the same f32 scores (the matmul path's is 1 by construction: its top-C
is exact) and the overlap of the two top-10 sets.

    python -m yams_tpu_torch.scripts.profile_grouped [--n 1000000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops.scan import dense_scores, grouped_topk_pallas
from ..ops.select import top_k
from ._common import device_name, qps_windows, recall


def unit_corpus(N: int, D: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """(N, D) bf16 rows of unit norm from a normal draw."""
    E = torch.randn(N, D, generator=gen, device=device, dtype=torch.bfloat16)
    norm = E.float().norm(dim=1, keepdim=True).clamp_min(1e-9)
    return (E / norm.to(torch.bfloat16)).contiguous()


def run(N: int = 1_000_000, D: int = 768, B: int = 256, iters: int = 8,
        block: int = 4096, group: int = 256, C: int = 32, windows: int = 3,
        device: str | torch.device = "cuda", seed: int = 0) -> dict:
    dev = resolve_device(device)
    N = -(-N // block) * block
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E = unit_corpus(N, D, gen, dev)
    Q = torch.randn(iters, B, D, generator=gen, device=dev)
    Q = Q / Q.norm(dim=-1, keepdim=True)
    valid = torch.ones(N, device=dev)

    def grouped(i):
        return grouped_topk_pallas(Q[i], E, valid, C, block_rows=block, group=group)

    def matmul(i):
        return top_k(dense_scores(Q[i], E, valid), C)

    g_qps, g_all = qps_windows(grouped, iters, B, windows, dev)
    m_qps, m_all = qps_windows(matmul, iters, B, windows, dev)
    g_ids = np.concatenate([grouped(i)[1][:, :10].cpu().numpy() for i in range(iters)])
    m_ids = np.concatenate([matmul(i)[1][:, :10].cpu().numpy() for i in range(iters)])
    exact = np.concatenate([top_k(dense_scores(Q[i], E, valid), 10)[1].cpu().numpy()
                            for i in range(iters)])
    return {
        "experiment": "profile_grouped", "device": device_name(dev),
        "shape": {"N": N, "D": D, "B": B, "iters": iters, "block": block,
                  "group": group, "C": C},
        "kernel_qps": g_qps, "kernel_qps_windows": g_all,
        "matmul_topc_qps": m_qps, "matmul_topc_qps_windows": m_all,
        "kernel_recall10": recall(g_ids, exact), "matmul_topc_recall10": recall(m_ids, exact),
        "overlap10": recall(g_ids, m_ids),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--group", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(run(a.n, a.d, a.b, a.iters, a.block, a.group, device=a.device)))


if __name__ == "__main__":
    main()
