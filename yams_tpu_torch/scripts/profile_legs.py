"""Leg-by-leg timing of the fused hybrid program at bench shapes.

Port of scripts/profile_legs.py on the port's search/fusion.py. Times, each
over ITERS batches of B queries after a warm-up batch (CUDA events on a
card, perf_counter on the host):
  vec_matmul       : q @ E.T only (the raw product + HBM cost)
  vec_approx_exact : the reference's vec_approx row (matmul +
                     lax.approx_max_k C). approx_max_k has no PyTorch
                     counterpart and the port's vector leg selects exactly,
                     so this row runs the exact top-C under its own name
  vec_exact_topk   : matmul + the exact tie-ordered top-C (select.top_k)
  bm25             : lexical candidates only (bm25_topk_candidates, CSR)
  full             : the production hybrid_query

The corpus is N x D unit bf16 rows and a hashed CSR posting list of VOCAB
terms x 512 rows (VOCAB 65,536, or N where N is smaller: a run on the
host), made on the device from one seed.

    python -m yams_tpu_torch.scripts.profile_legs [--device cuda|cpu]
Environment: BENCH_N (1,000,000), BENCH_D (768), BENCH_B (256) and
BENCH_ITERS (8), as the reference's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bm25 import bm25_topk_candidates
from ..ops.scan import dot_f32
from ..ops.select import top_k
from ..search.config import SearchEngineConfig
from ..search.fusion import hybrid_query, pack_weights
from ._common import batch_line, batch_ms


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    N = int(os.environ.get("BENCH_N", 1_000_000))
    D = int(os.environ.get("BENCH_D", 768))
    B = int(os.environ.get("BENCH_B", 256))
    ITERS = int(os.environ.get("BENCH_ITERS", 8))
    S, T, WINDOW, K, C = 4096, 16, 1024, 10, 32
    N = ((N + 1023) // 1024) * 1024
    VOCAB = min(65536, N)

    gen = torch.Generator(device=dev).manual_seed(0)
    E = torch.randn(N, D, generator=gen, device=dev).to(torch.bfloat16)
    E = (E / E.float().norm(dim=1, keepdim=True).clamp_min(1e-9).to(torch.bfloat16))
    proj = (torch.where(torch.rand(S, D, generator=gen, device=dev) < 0.5, 1.0, -1.0)
            / np.sqrt(D)).to(torch.bfloat16)
    valid = torch.ones(N, device=dev)
    row2slot = torch.arange(N, dtype=torch.int32, device=dev)
    row_scale = torch.ones(N, device=dev)
    per_term = WINDOW // 2
    P = VOCAB * per_term
    ar = torch.arange(P, dtype=torch.int64, device=dev)
    pd = ((ar * 2654435761) % (1 << 32) % N).to(torch.int32)
    pd = torch.cat([pd, torch.full((WINDOW,), N, dtype=torch.int32, device=dev)])
    pi = ((ar * 40503) % (1 << 32) % 190).to(torch.float32) / 40.0 + 0.5
    pi = torch.cat([pi, torch.zeros(WINDOW, device=dev)])
    del ar
    to = torch.arange(VOCAB, dtype=torch.int32, device=dev) * per_term
    tl = torch.full((VOCAB,), per_term, dtype=torch.int32, device=dev)
    doc_mask = torch.ones(N, device=dev)
    hot = torch.zeros(N, device=dev)
    w = torch.from_numpy(pack_weights(SearchEngineConfig())).to(dev)
    sketches = torch.randn(ITERS, B, S, generator=gen, device=dev)
    term_ids = torch.randint(0, VOCAB, (ITERS, B, T), generator=gen, device=dev,
                             dtype=torch.int32)
    term_mask = torch.ones(ITERS, B, T, device=dev)
    corpus = (proj, E, valid, row2slot, row_scale, pd, pi, to, tl, doc_mask, hot, w)
    out: dict[str, float] = {}

    def timed(name, fn):
        out[name], _ = batch_ms(fn, ITERS, dev)
        print(batch_line(name, out[name], B, 16), flush=True)

    def embed(sk):
        q = dot_f32(sk, proj.t())
        return q / q.norm(dim=-1, keepdim=True).clamp_min(1e-9)

    def vec_matmul(i):
        return dot_f32(embed(sketches[i]), E).sum(dim=1)   # cheap reduce keeps s live

    def vec_exact(i):
        return top_k(dot_f32(embed(sketches[i]), E), C)[0][:, 0]

    def bm25_only(i):
        return bm25_topk_candidates(term_ids[i], term_mask[i], pd, pi, to, tl,
                                    window=WINDOW, num_docs=N, num_candidates=C)[1][:, 0]

    def full(i):
        return hybrid_query(sketches[i], term_ids[i], term_mask[i], *corpus,
                            k=K, rrf_cand=C, window=WINDOW, num_slots=N,
                            chunk_agg="max", rows_are_docs=True, approx=True)[0][:, 0]

    timed("vec_matmul", vec_matmul)
    timed("vec_approx_exact", vec_exact)
    print("  (vec_approx: lax.approx_max_k has no PyTorch counterpart; this row is "
          "the exact top-C)", flush=True)
    timed("vec_exact_topk", vec_exact)
    timed("bm25", bm25_only)
    timed("full", full)
    return out


if __name__ == "__main__":
    main()
