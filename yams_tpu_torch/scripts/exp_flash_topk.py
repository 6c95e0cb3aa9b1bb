"""flash_topc (K2) against the matmul + top-C path at 1M x 768, clustered.

Port of scripts/exp_flash_topk.py. The clustered corpus bench.py uses
(4,096 unit centres, sigma 0.35 bf16 noise, rows renormalized; N a multiple
of the 16,384-row span) and `iters` batches of B unit queries are made on
the device from one seed. Each batch goes through

  - the kernel path: flash_topc (one survivor per strided 128-row window,
    fused with the product; K2 on a card), top-C, its first 10;
  - the matmul + top-C path: dot_f32 (the port's vector leg) + bias and the
    exact tie-ordered select.top_k, its first 10.

It reports the QPS of each (median of `windows` timed windows of `iters`
batches, every window listed) and recall@10 of each against the exact
top-10 of the same f32 scores (the matmul path's is 1 by construction).

    python -m yams_tpu_torch.scripts.exp_flash_topk [--n 1015808] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops.flash_topk import SPAN, flash_topc
from ..ops.scan import dot_f32
from ..ops.select import top_k
from ._common import device_name, qps_windows, recall


def clustered_corpus(N: int, D: int, n_clusters: int, sigma: float,
                     gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """Row r = centre[((r * 2654435761) mod 2^32 >> 7) % n_clusters] + sigma
    * bf16 noise, renormalized -> (N, D) bf16."""
    centers = torch.randn(n_clusters, D, generator=gen, device=device)
    centers /= centers.norm(dim=1, keepdim=True).clamp_min(1e-9)
    ar = torch.arange(N, device=device, dtype=torch.int64)
    assign = (((ar * 2654435761) & 0xFFFFFFFF) >> 7) % n_clusters
    noise = torch.randn(N, D, generator=gen, device=device, dtype=torch.bfloat16)
    e = centers[assign].to(torch.bfloat16) + sigma * noise
    del noise
    ef = e.float()
    del e
    return (ef / ef.norm(dim=1, keepdim=True).clamp_min(1e-9)).to(torch.bfloat16)


def clustered_inputs(N: int, D: int, B: int, iters: int, n_clusters: int, sigma: float,
                     device: torch.device, seed: int):
    """bench.py's clustered corpus, then `iters` batches of B unit queries,
    made on the device from one seed -> (queries (iters, B, D) f32, the
    corpus (N, D) bf16)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    E = clustered_corpus(N, D, n_clusters, sigma, gen, device)
    Q = torch.randn(iters, B, D, generator=gen, device=device)
    return Q / Q.norm(dim=-1, keepdim=True).clamp_min(1e-9), E


def run(N: int = 1_015_808, D: int = 768, B: int = 1024, iters: int = 8, C: int = 32,
        n_clusters: int = 4096, sigma: float = 0.35, windows: int = 3,
        device: str | torch.device = "cuda", seed: int = 0) -> dict:
    if N % SPAN:
        raise ValueError(f"N={N} must be a multiple of {SPAN}")
    dev = resolve_device(device)
    Q, E = clustered_inputs(N, D, B, iters, n_clusters, sigma, dev, seed)
    bias = torch.zeros(N, device=dev)

    def flash(i):
        return flash_topc(Q[i], E, bias, k=C)

    def matmul(i):
        return top_k(dot_f32(Q[i], E) + bias[None, :], C)

    f_qps, f_all = qps_windows(flash, iters, B, windows, dev)
    m_qps, m_all = qps_windows(matmul, iters, B, windows, dev)
    f_ids = np.concatenate([flash(i)[1][:, :10].cpu().numpy() for i in range(iters)])
    m_ids = np.concatenate([matmul(i)[1][:, :10].cpu().numpy() for i in range(iters)])
    exact = np.concatenate([top_k(dot_f32(Q[i], E) + bias[None, :], 10)[1].cpu().numpy()
                            for i in range(iters)])
    return {
        "experiment": "exp_flash_topk", "device": device_name(dev),
        "shape": {"N": N, "D": D, "B": B, "iters": iters, "C": C,
                  "clusters": n_clusters, "sigma": sigma},
        "kernel_qps": f_qps, "kernel_qps_windows": f_all,
        "matmul_topc_qps": m_qps, "matmul_topc_qps_windows": m_all,
        "kernel_recall10": recall(f_ids, exact), "matmul_topc_recall10": recall(m_ids, exact),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_015_808)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(run(a.n, a.d, a.b, a.iters, device=a.device)))


if __name__ == "__main__":
    main()
