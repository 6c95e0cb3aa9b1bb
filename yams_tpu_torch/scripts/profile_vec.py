"""Vector-leg variants at bench shapes (1M x 768, B 256).

Port of scripts/profile_vec.py. A unit-normal bf16 corpus of N rows
(rounded up to 1,024), its contiguous D0-dim prefix copy and ITERS batches
of B unit queries are made on the device from one seed. Each row runs the
ITERS batches after a warm-up batch (CUDA events on a card, the host clock
on the CPU):

  exact_topk        : dot_f32 (bf16 operands, f32 scores) + the exact top-10
  base_f32_exact    : dot_f32 + the top-C        (the reference's base_f32)
  scores_bf16_exact : dot_bf16 (bf16 scores) + the top-C   (scores_bf16)
  mat192_exact      : the prefix scan (dot_f32 over D0 dims) + the top
                      RERANK*C, the candidates rescored at full dimension
                      (a row gather and a batched product with f32 sums),
                      their top-C                                (mat192)
  mat192_bf16_exact : the same with bf16 prefix scores      (mat192_bf16)

then each row's top-10 overlap with exact_topk's. The reference's four
variants select with lax.approx_max_k, which has no PyTorch counterpart:
here they select exactly (select.top_k, lax.top_k's tie order) and carry
the suffix _exact. So base_f32_exact's overlap is 1 by construction, and
the others' measure only the bf16 scores and the prefix scan.

    python -m yams_tpu_torch.scripts.profile_vec [--device cuda|cpu]
Environment: BENCH_N (1,000,000), BENCH_D (768), BENCH_B (256),
BENCH_ITERS (8) and BENCH_D0 (192), as the reference's.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..device import resolve_device
from ..ops.matryoshka import prefix_corpus, rescore_topk
from ..ops.scan import dot_f32
from ..ops.select import top_k
from ._common import batch_line, batch_ms, device_name, dot_bf16, recall
from .profile_grouped import unit_corpus

C, RERANK = 32, 4


def exact(q, E, k: int = 10):
    return top_k(dot_f32(q, E), k)


def base_f32(q, E, C: int = C):
    v, i = top_k(dot_f32(q, E), C)
    return v[:, :10], i[:, :10]


def scores_bf16(q, E, C: int = C):
    v, i = top_k(dot_bf16(q, E), C)
    return v[:, :10].float(), i[:, :10]


def mat(q, E, E0, bf16: bool, C: int = C, rerank: int = RERANK):
    q0 = q[:, :E0.shape[1]]
    s0 = dot_bf16(q0, E0) if bf16 else dot_f32(q0, E0)
    _, ci = top_k(s0, C * rerank)
    v, i = rescore_topk(q, E, ci, C)
    return v[:, :10], i[:, :10]


ROWS = (("exact_topk", lambda q, E, E0: exact(q, E)),
        ("base_f32_exact", lambda q, E, E0: base_f32(q, E)),
        ("scores_bf16_exact", lambda q, E, E0: scores_bf16(q, E)),
        ("mat192_exact", lambda q, E, E0: mat(q, E, E0, False)),
        ("mat192_bf16_exact", lambda q, E, E0: mat(q, E, E0, True)))


def measure(Q, E, E0, device: torch.device) -> dict:
    """Time the five rows over Q (ITERS, B, D) and print them with the
    overlap line."""
    iters, B = Q.shape[:2]
    out: dict = {"experiment": "profile_vec", "device": device_name(device),
                 "shape": {"N": E.shape[0], "D": E.shape[1], "B": B, "iters": iters,
                           "D0": E0.shape[1], "C": C, "rerank": RERANK}, "ms": {}}
    ids = {}
    for name, fn in ROWS:
        out["ms"][name], res = batch_ms(lambda i: fn(Q[i], E, E0), iters, device)
        print(batch_line(name, out["ms"][name], B), flush=True)
        ids[name] = torch.cat([r[1] for r in res]).cpu().numpy()
    print("  (base_f32, scores_bf16, mat192, mat192_bf16: lax.approx_max_k has no PyTorch "
          "counterpart; these rows select their top-C exactly)", flush=True)
    ex = ids["exact_topk"]
    out["overlap"] = {name: recall(ids[name], ex) for name, _ in ROWS[1:]}
    o = list(out["overlap"].values())
    print(f"overlap vs exact: base={o[0]:.3f} bf16={o[1]:.3f} mat192={o[2]:.3f} "
          f"mat192_bf16={o[3]:.3f}", flush=True)
    return out


def make_inputs(N: int, D: int, B: int, iters: int, D0: int, device: torch.device,
                seed: int):
    """-> (queries (iters, B, D) f32, the corpus (N rounded up to 1,024, D)
    bf16, its contiguous (N, D0) prefix copy), on the device."""
    N = -(-N // 1024) * 1024
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    E = unit_corpus(N, D, gen, device)
    Q = torch.randn(iters, B, D, generator=gen, device=device)
    return Q / Q.norm(dim=-1, keepdim=True), E, prefix_corpus(E, D0)


def run(N: int = 1_000_000, D: int = 768, B: int = 256, iters: int = 8, D0: int = 192,
        device: str | torch.device = "cuda", seed: int = 0) -> dict:
    dev = resolve_device(device)
    return measure(*make_inputs(N, D, B, iters, D0, dev, seed), dev)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(N=int(os.environ.get("BENCH_N", 1_000_000)),
               D=int(os.environ.get("BENCH_D", 768)),
               B=int(os.environ.get("BENCH_B", 256)),
               iters=int(os.environ.get("BENCH_ITERS", 8)),
               D0=int(os.environ.get("BENCH_D0", 192)), device=args.device)


if __name__ == "__main__":
    main()
