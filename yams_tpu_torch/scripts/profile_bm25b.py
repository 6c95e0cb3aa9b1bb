"""BM25 gather-layout variants: element gathers vs row gathers vs packed.

Port of scripts/profile_bm25b.py, on profile_bm25's hashed postings. Each
row runs ITERS batches of B queries after a warm-up batch (CUDA events on a
card, the host clock on the CPU):

  slice_csr   : production's layout, each term's window sliced from the
                1-D CSR postings (element gathers)
  dense2d     : the postings as (V, W) doc and impact matrices, one row
                gather a term
  dense2d_pk  : the (V, W) packed i32 matrix (doc << QBITS | impact
                quantized under the static ceiling VMAX 5.5), half the bytes
  full_packed : dense2d_pk + one sort + the segment sums + the top-C (the
                candidate stage end to end)

then full_packed's top-1 score against production's bm25_topk_candidates
(the relative error). The (V, W) matrices are built on the device, as the
reference's build_2d does. Their static quantization is not ops/bm25.py
pack_postings_2d's, which scales by the postings' own maximum.

    python -m yams_tpu_torch.scripts.profile_bm25b [--device cuda|cpu]
Environment: BENCH_N (1,000,000), BENCH_B (256) and BENCH_ITERS (8), as
the reference's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ops.bm25 import bm25_topk_candidates, packed_qbits
from ._common import batch_line, batch_ms, device_name
from .profile_bm25 import (C, T, VMAX, VOCAB, WINDOW, gather, make_inputs,
                           max_postings_per_doc, packed_candidates, quantize_keys)


def build_2d(pd, pi, to, tl, window: int, N: int):
    """(V, window) dense views of the CSR postings: row v holds term v's
    postings, sink padded -> (docs i32, impacts f32, packed keys i32 with
    the sink key N << qbits in the padding)."""
    qbits = packed_qbits(N)
    pos = torch.arange(window, device=pd.device)
    idx = (to.long()[:, None] + pos).clamp(0, pd.shape[0] - 1)
    ok = pos < tl[:, None]
    d2 = torch.where(ok, pd[idx], N)
    i2 = torch.where(ok, pi[idx], 0.0)
    del idx
    pk = torch.where(ok, quantize_keys(d2, i2, qbits, VMAX), N << qbits)
    return d2, i2, pk


def measure(term_ids, term_mask, pd, pi, to, tl, N: int, device: torch.device,
            window: int = WINDOW, num_candidates: int = C) -> dict:
    """Build the (V, W) views, time the four rows over term_ids / term_mask
    (ITERS, B, T) and print them with the relative-error line."""
    iters, B = term_ids.shape[:2]
    qbits = packed_qbits(N)
    sink = N << qbits
    d2, i2, pk = build_2d(pd, pi, to, tl, window, N)

    def slice_csr(i):
        d, v = gather(term_ids[i], term_mask[i], pd, pi, to, tl, window, N)
        return v.sum(dim=(1, 2)), d.amax(dim=(1, 2))

    def dense2d(i):
        tids = term_ids[i].long()
        v = i2[tids] * term_mask[i][:, :, None]
        return v.sum(dim=(1, 2)), d2[tids].amax(dim=(1, 2))

    def packed_rows(i):
        k = pk[term_ids[i].long()]
        return torch.where(term_mask[i][:, :, None] > 0, k, sink)

    def dense2d_pk(i):
        k = packed_rows(i)
        return k.amax(dim=(1, 2)), k.amin(dim=(1, 2))

    def full_packed(i):
        return packed_candidates(packed_rows(i), N, num_candidates, qbits, VMAX)[1][:, 0]

    def production(i):
        return bm25_topk_candidates(term_ids[i], term_mask[i], pd, pi, to, tl, window=window,
                                    num_docs=N, num_candidates=num_candidates)[1][:, 0]

    out: dict = {"experiment": "profile_bm25b", "device": device_name(device),
                 "shape": {"N": N, "B": B, "iters": iters, "T": term_ids.shape[2],
                           "vocab": to.shape[0], "window": window, "C": num_candidates,
                           "qbits": qbits, "vmax": VMAX}, "ms": {}}
    res = {}
    for name, fn in (("slice_csr", slice_csr), ("dense2d", dense2d),
                     ("dense2d_pk", dense2d_pk), ("full_packed", full_packed)):
        out["ms"][name], res[name] = batch_ms(fn, iters, device)
        print(batch_line(name, out["ms"][name], B), flush=True)
    r = torch.cat(res["full_packed"]).cpu().numpy()
    r2 = torch.cat([production(i) for i in range(iters)]).cpu().numpy()
    out["top1_abs_err"] = float(np.abs(r - r2).max())
    out["rel_err"] = out["top1_abs_err"] / max(float(np.abs(r2).max()), 1e-9)
    print(f"full_packed vs production top1 rel err: {out['rel_err']:.2e}", flush=True)
    out["impact_mass_max"] = float(max(float(mass.max()) for mass, _ in res["slice_csr"]))
    out["max_postings_per_doc"] = max_postings_per_doc(term_ids, term_mask, pd, pi, to, tl,
                                                       window, N)
    return out


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
