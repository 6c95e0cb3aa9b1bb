"""bf16 coarse scores + an exact f32 rescore of the candidates, on the card.

Port of scripts/exp_coarse_bf16.py. The premise it tests: the materialized
(B, N) f32 score matrix costs more traffic than the corpus read, and bf16
coarse scores halve it, while an f32 rescore of the top-C candidates keeps
the final values exact as long as the true top-10 survive the coarse cut.

bench.py's clustered corpus (N 1,000,448 x 768, 4,096 centres, sigma 0.35)
and ITERS batches of B 1,024 unit queries are made on the device from one
seed. Each mode runs the ITERS batches, timed as the best of three passes
after a warm-up (CUDA events on a card, the host clock on the CPU):

  f32    : dot_f32 (bf16 operands, f32 scores) + the top-C
  bf16nr : dot_bf16 (bf16 scores) + the top-C of the bf16 values, no rescore
  bf16   : dot_bf16 + the top-cc candidates, rescored in f32 (a row gather
           and a batched product with f32 sums), their top-C; cc = C and 4C
  exact  : dot_f32 + the exact top-C (the oracle)

with recall@10 against the oracle. The reference selects with
lax.approx_max_k, which has no PyTorch counterpart: every mode here selects
exactly (select.top_k, lax.top_k's tie order), so its lines carry
"[exact top-C]". f32 is then the oracle's own program (recall 1 by
construction): it is timed once, and its line carries the oracle's time.
bf16nr and bf16 isolate the bf16 rounding of the scores.

    python -m yams_tpu_torch.scripts.exp_coarse_bf16 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.matryoshka import rescore_topk
from ..ops.scan import dot_f32
from ..ops.select import top_k
from ._common import batch_ms, device_name, dot_bf16, recall
from .exp_flash_topk import clustered_inputs

K = 10


def coarse(q, E, mode: str, C: int, cc: int):
    """One batch of one mode -> (top-K values f32, ids)."""
    if mode in ("f32", "exact"):
        v, i = top_k(dot_f32(q, E), cc if mode == "f32" else C)
    elif mode == "bf16nr":
        v, i = top_k(dot_bf16(q, E), cc)
    else:
        _, ci = top_k(dot_bf16(q, E), cc)
        v, i = rescore_topk(q, E, ci, C)
    return v[:, :K].float(), i[:, :K]


def measure(qs, E, device: torch.device, C: int = 32) -> dict:
    """Time every mode over qs (ITERS, B, D) and print the reference's
    lines."""
    iters, B = qs.shape[:2]
    out: dict = {"experiment": "exp_coarse_bf16", "device": device_name(device),
                 "shape": {"N": E.shape[0], "D": E.shape[1], "B": B, "iters": iters, "C": C},
                 "rows": {}}

    def timed(mode, cc=C):
        ms, res = batch_ms(lambda i: coarse(qs[i], E, mode, C, cc), iters, device, best_of=3)
        return ms, torch.cat([r[1] for r in res]).cpu().numpy()

    def row(key, ms, ids, line):
        r = {"ms": ms, "qps": B * 1e3 / ms, "recall10": recall(ids, i_exact),
             "speedup": t_exact / ms}
        out["rows"][key] = r
        print(line.format(**r), flush=True)

    t_exact, i_exact = timed("exact")
    out["rows"]["exact"] = {"ms": t_exact, "qps": B * 1e3 / t_exact,
                            "recall10": recall(i_exact, i_exact)}
    row("f32", t_exact, i_exact, f"f32  coarse C={C:4d} [exact top-C]: {{qps:9.1f}} qps  "
        "recall@10={recall10:.4f}  (same program as the exact oracle, its time)")
    t_nr, i_nr = timed("bf16nr", C)
    row("bf16nr", t_nr, i_nr, f"bf16 norescore C={C:2d} [exact top-C]: {{qps:9.1f}} qps  "
        "recall@10={recall10:.4f}  speedup={speedup:.3f}x")
    for cc in (C, 4 * C):
        t_bf, i_bf = timed("bf16", cc)
        row(f"bf16_C{cc}", t_bf, i_bf, f"bf16 coarse C={cc:4d} [exact top-C]: {{qps:9.1f}} qps  "
            "recall@10={recall10:.4f}  speedup={speedup:.3f}x")
    return out


def run(N: int = 1_000_448, D: int = 768, B: int = 1024, iters: int = 8, C: int = 32,
        n_clusters: int = 4096, sigma: float = 0.35, device: str | torch.device = "cuda",
        seed: int = 0) -> dict:
    dev = resolve_device(device)
    qs, E = clustered_inputs(N, D, B, iters, n_clusters, sigma, dev, seed)
    return measure(qs, E, dev, C)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
