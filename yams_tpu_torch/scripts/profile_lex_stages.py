"""The packed lexical leg's stages, one by one, at bench shape.

Port of scripts/profile_lex_stages.py (B 512, T 16, W 1,024, V 65,536,
qbits 11; its N of 2**20 is used nowhere), which did its work at import
time; here `run` does it.
A (V, W) matrix of uniform int32 keys >> 1 (an arithmetic shift, so
negative keys occur: the stages are timed, no rank is claimed) stands in
for the packed postings, and each stage adds one step to the one before:

  gather              : the query terms' rows, (B, T * W)
  gather+sort         : + a sort of each query's keys
  +segsum             : + ids and impacts unpacked and each run of equal
                        ids summed (ops/bm25.py segment_totals: the prefix
                        sum select.prefix_sum, the cummax bases)
  +topk(full)         : + the top-32 of the totals (select.top_k), their ids
  +approxk(full)_exact: the reference's +approxk(full) row (lax.approx_max_k
                        instead of top_k). approx_max_k has no PyTorch
                        counterpart, so this row is +topk(full), printed
                        under its own name with +topk(full)'s time
  persort1024         : the rows gathered and each term's W keys sorted
                        alone (does the sort's log^2 cost show?)

Each row is the mean of 4 runs after a warm-up (CUDA events on a card, the
host clock on the CPU).

    python -m yams_tpu_torch.scripts.profile_lex_stages [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.bm25 import segment_totals
from ..ops.select import top_k
from ._common import batch_ms, device_name


def segments(packed, tids, qbits: int):
    """Gather, sort, unpack and sum each run of equal ids: -> (totals (B,
    T * W) f32, at the last key of each run and 0 elsewhere; ids (B, T * W)
    i32)."""
    B = tids.shape[0]
    keys = packed[tids.long()].reshape(B, -1).sort(dim=1).values
    ids = keys >> qbits
    return segment_totals(ids, (keys & ((1 << qbits) - 1)).float()), ids


def stages(packed, tids, qbits: int, k: int = 32) -> list:
    """[(name, fn)] of the six rows; fn() -> the stage's outputs."""
    B = tids.shape[0]

    def gather():
        return packed[tids.long()].reshape(B, -1).sum(dim=1)

    def gather_sort():
        return packed[tids.long()].reshape(B, -1).sort(dim=1).values.sum(dim=1)

    def segsum():
        seg, ids = segments(packed, tids, qbits)
        return seg.sum(dim=1), ids.sum(dim=1)

    def full():
        seg, ids = segments(packed, tids, qbits)
        v, p = top_k(seg, k)
        return v, ids.gather(1, p)

    def persort():
        return packed[tids.long()].sort(dim=2).values.sum(dim=(1, 2))

    return [("gather", gather), ("gather+sort", gather_sort), ("+segsum", segsum),
            ("+topk(full)", full), ("+approxk(full)_exact", full), ("persort1024", persort)]


def run(B: int = 512, T: int = 16, W: int = 1024, V: int = 65536, qbits: int = 11,
        reps: int = 4, device: str | torch.device = "cuda", seed: int = 0) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    packed = torch.randint(-(1 << 31), (1 << 31) - 1, (V, W), generator=gen, device=dev,
                           dtype=torch.int32) >> 1
    tids = torch.randint(0, V, (B, T), generator=gen, device=dev, dtype=torch.int32)
    out: dict = {"experiment": "profile_lex_stages", "device": device_name(dev),
                 "shape": {"B": B, "T": T, "W": W, "V": V, "qbits": qbits,
                           "reps": reps}, "ms": {}}
    timed = {}          # fn -> the row that timed it
    for name, fn in stages(packed, tids, qbits):
        if fn in timed:
            out["ms"][name] = out["ms"][timed[fn]]
            print(f"{name:16s} {out['ms'][name]:7.2f} ms  (same program as {timed[fn]}, "
                  "its time)", flush=True)
        else:
            out["ms"][name], _ = batch_ms(lambda i: fn(), reps, dev)
            timed[fn] = name
            print(f"{name:16s} {out['ms'][name]:7.2f} ms", flush=True)
        if name == "+approxk(full)_exact":
            print("  (+approxk(full): lax.approx_max_k has no PyTorch counterpart; this row "
                  "is +topk(full))", flush=True)
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
