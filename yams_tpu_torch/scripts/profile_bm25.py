"""BM25 candidate-generation variants, timed at bench shapes.

Port of scripts/profile_bm25.py. Each row runs ITERS batches of B queries of
T terms over hashed CSR postings (VOCAB terms x WINDOW/2 docs of N, sink
padded), after a warm-up batch (CUDA events on a card, the host clock on
the CPU):

  gather_only       : the windows' gather (the floor)
  sort2             : production, ops/bm25.py bm25_topk_candidates (a
                      stable sort of the ids carrying the impacts)
  packed1           : a single-key sort: the impact quantized (static
                      ceiling VMAX 5.5) into the low QBITS bits of the id key
  packed1_axk_exact : the reference's packed1_axk row (packed +
                      lax.approx_max_k). approx_max_k has no PyTorch
                      counterpart, so this row is packed1's exact top-C,
                      printed under its own name with packed1's time

then packed1's top-1 score against sort2's (the relative error). The
reference vmaps one query at a time; here each batch is one (B, T * WINDOW)
pass. The postings' hashes wrap at 2**32 as the reference's uint32 do.

    python -m yams_tpu_torch.scripts.profile_bm25 [--device cuda|cpu]
Environment: BENCH_N (1,000,000), BENCH_B (256) and BENCH_ITERS (8), as
the reference's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bm25 import bm25_topk_candidates, packed_qbits, segment_topk, segment_totals
from ._common import batch_line, batch_ms, device_name

T, VOCAB, WINDOW, C = 16, 65536, 1024, 32
VMAX = 5.5   # the static impact ceiling at these shapes (the largest impact is 5.225)


def hashed_postings(N: int, V: int, window: int, device: torch.device):
    """V terms x window/2 postings each: doc (r * 2654435761 mod 2**32) % N
    and impact ((r * 40503 mod 2**32) % 190) / 40 + 0.5 for posting r, then
    `window` sink entries (doc N, impact 0). -> (postings_doc (P + window,)
    i32, postings_impact f32, term_offsets (V,) i32, term_lengths i32)."""
    per_term = window // 2
    ar = torch.arange(V * per_term, dtype=torch.int64, device=device)
    pd = (((ar * 2654435761) & 0xFFFFFFFF) % N).to(torch.int32)
    pi = (((ar * 40503) & 0xFFFFFFFF) % 190).to(torch.float32)
    # a tensor divisor: a card turns division by a Python number into a
    # multiply by its reciprocal, which rounds otherwise
    pi = pi / torch.tensor(40.0, device=device) + 0.5
    del ar
    pd = torch.cat([pd, torch.full((window,), N, dtype=torch.int32, device=device)])
    pi = torch.cat([pi, torch.zeros(window, device=device)])
    to = torch.arange(V, dtype=torch.int32, device=device) * per_term
    tl = torch.full((V,), per_term, dtype=torch.int32, device=device)
    return pd, pi, to, tl


def gather(tids, tmask, pd, pi, to, tl, window: int, N: int):
    """Each query term's window of the CSR postings: (B, T) term ids and
    weights -> (docs (B, T, window) i32, impacts f32), slots past the term's
    length or of a masked term at (N, 0)."""
    tid = tids.long()
    pos = torch.arange(window, device=pd.device)
    idx = to[tid].long().clamp(0, pd.shape[0] - window)[:, :, None] + pos
    ok = (pos < tl[tid][:, :, None]) & (tmask[:, :, None] > 0)
    return torch.where(ok, pd[idx], N), torch.where(ok, pi[idx], 0.0)


def quantize_keys(ids, val, qbits: int, vmax: float):
    """The i32 keys ids << qbits | round(val * qmax / vmax), the impact
    clipped to [0, qmax]."""
    qmax = (1 << qbits) - 1
    quant = torch.clamp(torch.round(val * (qmax / vmax)), 0, qmax).to(torch.int32)
    return (ids.to(torch.int32) << qbits) | quant


def packed_candidates(keys, N: int, num_candidates: int, qbits: int, vmax: float):
    """(B, L) packed keys -> top-C (ids (B, C) i32, per-doc sums (B, C) f32):
    one sort, the quantized impacts dequantized, then ops/bm25.py's segment
    sums (select.prefix_sum, cummax bases, the sink and empty slots at N)."""
    qmax = (1 << qbits) - 1
    keys = keys.reshape(keys.shape[0], -1).sort(dim=1).values
    return segment_topk(keys >> qbits, (keys & qmax).float() * (vmax / qmax), N,
                         num_candidates)


def max_postings_per_doc(term_ids, term_mask, pd, pi, to, tl, window: int, N: int) -> int:
    """The most postings one doc holds in one query's windows, over every
    batch (the sink aside): a doc's quantized sum is off by at most half a
    quantization step for each."""
    most = 0
    for i in range(term_ids.shape[0]):
        ids, _ = gather(term_ids[i], term_mask[i], pd, pi, to, tl, window, N)
        ids = ids.reshape(ids.shape[0], -1).sort(dim=1).values
        runs = segment_totals(ids, torch.ones(ids.shape, device=ids.device))
        most = max(most, int(torch.where(ids < N, runs, 0.0).max()))
    return most


def measure(term_ids, term_mask, pd, pi, to, tl, N: int, device: torch.device,
            window: int = WINDOW, num_candidates: int = C) -> dict:
    """Time the rows over term_ids / term_mask (ITERS, B, T) and print
    them with the relative-error line."""
    iters, B = term_ids.shape[:2]
    qbits = packed_qbits(N)

    def gather_only(i):
        ids, val = gather(term_ids[i], term_mask[i], pd, pi, to, tl, window, N)
        return val.sum(dim=(1, 2)), ids.amax(dim=(1, 2))

    def sort2(i):
        return bm25_topk_candidates(term_ids[i], term_mask[i], pd, pi, to, tl, window=window,
                                    num_docs=N, num_candidates=num_candidates)[1][:, 0]

    def packed1(i):
        ids, val = gather(term_ids[i], term_mask[i], pd, pi, to, tl, window, N)
        keys = quantize_keys(ids, val, qbits, VMAX)
        return packed_candidates(keys, N, num_candidates, qbits, VMAX)[1][:, 0]

    out: dict = {"experiment": "profile_bm25", "device": device_name(device),
                 "shape": {"N": N, "B": B, "iters": iters, "T": term_ids.shape[2],
                           "vocab": to.shape[0], "window": window, "C": num_candidates,
                           "qbits": qbits, "vmax": VMAX}, "ms": {}}
    res = {}
    for name, fn in (("gather_only", gather_only), ("sort2", sort2), ("packed1", packed1)):
        out["ms"][name], res[name] = batch_ms(fn, iters, device)
        print(batch_line(name, out["ms"][name], B), flush=True)
    out["ms"]["packed1_axk_exact"] = out["ms"]["packed1"]
    print(batch_line("packed1_axk_exact", out["ms"]["packed1"], B)
          + "  (same program as packed1, its time)", flush=True)
    print("  (packed1_axk: lax.approx_max_k has no PyTorch counterpart; this row is "
          "packed1's exact top-C)", flush=True)
    r1, r2 = (torch.cat(res[name]).cpu().numpy() for name in ("packed1", "sort2"))
    out["top1_abs_err"] = float(np.abs(r1 - r2).max())
    out["rel_err"] = out["top1_abs_err"] / max(float(np.abs(r2).max()), 1e-9)
    print(f"packed vs exact top1 rel err: {out['rel_err']:.2e}", flush=True)
    out["impact_mass_max"] = float(max(float(mass.max()) for mass, _ in res["gather_only"]))
    out["max_postings_per_doc"] = max_postings_per_doc(term_ids, term_mask, pd, pi, to, tl,
                                                       window, N)
    return out


def make_inputs(N: int, B: int, iters: int, T: int, vocab: int, window: int,
                device: str | torch.device, seed: int):
    """N rounded up to 1,024, the hashed postings and (iters, B, T) uniform
    term ids with weight 1, on the device -> (measure's positional
    arguments, N, device)."""
    dev = resolve_device(device)
    N = -(-N // 1024) * 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    postings = hashed_postings(N, vocab, window, dev)
    term_ids = torch.randint(0, vocab, (iters, B, T), generator=gen, device=dev,
                             dtype=torch.int32)
    return (term_ids, torch.ones(iters, B, T, device=dev), *postings), N, dev


def run(N: int = 1_000_000, B: int = 256, iters: int = 8, T: int = T, vocab: int = VOCAB,
        window: int = WINDOW, C: int = C, device: str | torch.device = "cuda",
        seed: int = 0) -> dict:
    args, N, dev = make_inputs(N, B, iters, T, vocab, window, device, seed)
    return measure(*args, N=N, device=dev, window=window, num_candidates=C)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(N=int(os.environ.get("BENCH_N", 1_000_000)),
               B=int(os.environ.get("BENCH_B", 256)),
               iters=int(os.environ.get("BENCH_ITERS", 8)), device=args.device)


if __name__ == "__main__":
    main()
