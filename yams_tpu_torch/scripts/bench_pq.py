"""PQ4 capacity-tier benchmark: N x 768-d on ONE card, beyond bf16 memory.

Port of scripts/bench_pq.py. The packed 4-bit PQ tier holds N x 768 rows in
N x 24 bytes of codes + an f32 validity mask (16,777,216 rows: ~400 MB of
codes, where the dense bf16 corpus would be 25.8 GB); the ADC scan's top-64
candidates are exactly rescored and fused into the final top-10 (the rerank
of index/vector_index.py search_pq).

Everything heavy stays on the device: chunks of CHUNK rows (1,048,576, or
N where N is smaller: a run on the host) are generated, encoded and packed
there; only the 8,192-row codebook-training sample, the
256 query rows and the final (256, 10) ids cross the host link.

Ground truth without an oracle scan: each query has 10 planted perturbed
copies (cosine ~0.97) at known rows inside chunk 0; random 768-d
distractors sit at cosine ~0 +- 0.04, so the planted set is the true top-10
with near certainty. recall@10 = the fraction of planted rows found. The
exact-rerank leg reads a device-resident bf16 mirror of chunk 0 (every true
positive lives there); out-of-chunk candidates keep their ADC score.

Environment: PQ_IMPL = pallas (default: K4, `pq4_adc_cuda` through
pq4_adc_topk_pallas; its plain twin with --device cpu) or xla (the plain
ADC scan of ops/pq.py `pq_adc_topk`, packed4); PQ_BLOCK (2,048 for pallas,
262,144 for xla); PQ_GROUP (128). It runs on the card unless --device cpu
is given.

    python -m yams_tpu_torch.scripts.bench_pq [N_rows] [--device cuda|cpu]
        (N_rows default 16,777,216)
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.pq import pq_adc_topk, pq_encode, pq_train
from ..ops.pq_pallas import pq4_adc_topk_pallas
from ..ops.select import top_k
from ._common import card_line, sync


def pack4(codes: torch.Tensor) -> torch.Tensor:
    """(n, m) codes < 16 -> (n, m//2) nibbles on their device."""
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).to(torch.uint8)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("N", nargs="?", type=int, default=16_777_216)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    D, M, KSUB = 768, 48, 16
    IMPL = os.environ.get("PQ_IMPL", "pallas")  # pallas | xla
    BLOCK = int(os.environ.get("PQ_BLOCK", 2048 if IMPL == "pallas" else 262_144))
    GROUP = int(os.environ.get("PQ_GROUP", 128))
    CHUNK = min(1_048_576, args.N)
    N = max((args.N // CHUNK) * CHUNK, CHUNK)
    NQ, DUPS, RERANK_C = 256, 10, 64
    rng = np.random.default_rng(0)

    def gen_chunk(seed: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        v = torch.randn(CHUNK, D, generator=g, device=dev)
        return v / v.norm(dim=1, keepdim=True)

    t0 = time.time()
    base_rows = rng.choice(CHUNK, NQ, replace=False)
    planted = rng.choice(np.setdiff1d(np.arange(CHUNK), base_rows), NQ * DUPS,
                         replace=False).reshape(NQ, DUPS)
    truth = np.concatenate([base_rows[:, None], planted], axis=1)   # (NQ, 11)
    c0 = gen_chunk(0)
    q_dev = c0[torch.from_numpy(base_rows).to(dev)]                  # (NQ, D)
    # ||noise|| ~= 0.25 total: planted copies at cosine ~0.97 from their base
    noise = (0.25 / float(np.sqrt(D))) * torch.randn(
        NQ, DUPS, D, generator=torch.Generator(device=dev).manual_seed(99), device=dev)
    p = q_dev[:, None, :] + noise
    p = p / p.norm(dim=-1, keepdim=True)
    c0[torch.from_numpy(planted.reshape(-1)).to(dev)] = p.reshape(-1, D)
    c0_exact = c0.to(torch.bfloat16)                                 # rerank mirror
    print(f"chunk0 + planting: {time.time()-t0:.0f}s", flush=True)

    t0 = time.time()
    sample_rows = torch.from_numpy(rng.choice(CHUNK, min(8192, CHUNK), replace=False))
    cb = pq_train(c0[sample_rows.to(dev)].cpu().numpy(), m=M, ksub=KSUB,
                  train_limit=8192, iters=10, device=dev)
    sync(dev)
    print(f"train: {time.time()-t0:.0f}s", flush=True)

    t0 = time.time()
    codes_parts = [pack4(pq_encode(cb, c0))]
    del c0
    for gi in range(1, N // CHUNK):
        codes_parts.append(pack4(pq_encode(cb, gen_chunk(gi))))
        if gi % 4 == 3:
            sync(dev)
            print(f"  encoded {(gi+1)*CHUNK/1e6:.0f}M/{N/1e6:.0f}M rows "
                  f"({time.time()-t0:.0f}s)", flush=True)
    codes_dev = torch.cat(codes_parts)
    del codes_parts
    valid_dev = torch.ones(N, dtype=torch.float32, device=dev)
    sync(dev)
    print(f"gen+encode+pack: {time.time()-t0:.0f}s "
          f"({N/(time.time()-t0):,.0f} rows/s)", flush=True)
    hbm_mb = (codes_dev.numel() + valid_dev.numel() * 4) / 1e6
    print(f"device codes+mask: {hbm_mb:.0f} MB + {c0_exact.numel() * 2 / 1e6:.0f} MB "
          f"rerank mirror (dense bf16 would be {N*D*2/1e9:.1f} GB)", flush=True)

    def fused_search(q, codes, cents, valid, mirror):
        if IMPL == "pallas":
            av, ai = pq4_adc_topk_pallas(q, codes, cents, valid, RERANK_C,
                                         group=GROUP, block_rows=BLOCK)
        else:
            av, ai = pq_adc_topk(q, codes, cents, valid, k=RERANK_C,
                                 block_rows=BLOCK, packed4=True, group=GROUP)
        g = mirror[ai.long().clamp(0, CHUNK - 1)]                     # (NQ, C, D) bf16
        ex = torch.einsum("qcd,qd->qc", g.float(), q)
        s = torch.where(ai < CHUNK, ex, av)                           # exact where mirrored
        _, pos = top_k(s, 10)
        return ai.gather(1, pos)

    top10 = fused_search(q_dev, codes_dev, cb.centroids, valid_dev, c0_exact).cpu().numpy()

    t0 = time.time()
    ROUNDS = 5
    for _ in range(ROUNDS):
        top10 = fused_search(q_dev, codes_dev, cb.centroids, valid_dev,
                             c0_exact).cpu().numpy()
    dt = (time.time() - t0) / ROUNDS
    qps = NQ / dt

    hits = np.mean([len(set(top10[i]) & set(truth[i])) / 10 for i in range(NQ)])
    self1 = float(np.mean(top10[:, 0] == base_rows))
    out = {"metric": f"pq4_qps_{N}x{D}", "value": round(qps, 1), "unit": "qps",
           "impl": IMPL, "recall10_planted": round(float(hits), 3),
           "self_recall1": round(self1, 2), "batch": NQ, "hbm_mb": round(hbm_mb),
           "ms": dt * 1e3, "card": card_line(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
