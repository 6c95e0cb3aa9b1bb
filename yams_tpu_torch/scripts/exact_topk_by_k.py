"""Time the exact KNN block kernel K3 (`exact_topk_cuda`) of one checkout at
the bench shape (1,048,576 x 768 clustered bf16, 1,024 queries, block_rows
2,048) for several k, beside its plain twin `exact_topk_reference`.

    python3 yams_tpu_torch/scripts/exact_topk_by_k.py [--tree DIR] [--k 10 17 100 128] [--reps 3]

--tree names the checkout whose `yams_tpu_torch` is imported (by default
the one this file is in), so the same script times an earlier commit's
kernel, unpacked with `git archive`, on the same seeded data. Run it as a
file, not with -m, so that the package comes from --tree. Each k's result is
held against the tree's own twin (ids that differ are counted, not refused).
Needs a card and nvcc. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import subprocess
import sys

import torch

HERE_TREE = pathlib.Path(__file__).resolve().parents[2]


def clustered_corpus(N: int, D: int, gen, dev) -> torch.Tensor:
    """The bench corpus: 4,096 unit centers, sigma 0.35 bf16 noise, rows
    L2-normalized -> (N, D) bf16."""
    centers = torch.randn(4096, D, generator=gen, device=dev)
    centers /= centers.norm(dim=1, keepdim=True).clamp_min(1e-9)
    ar = torch.arange(N, device=dev, dtype=torch.int64)
    assign = (((ar * 2654435761) & 0xFFFFFFFF) >> 7) % 4096
    e = centers[assign] + 0.35 * torch.randn(N, D, generator=gen, device=dev)
    return (e / e.norm(dim=1, keepdim=True).clamp_min(1e-9)).to(torch.bfloat16)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(tree: pathlib.Path, ks: list[int], reps: int, seed: int = 0) -> dict:
    sys.path.insert(0, str(tree))
    scan = importlib.import_module("yams_tpu_torch.ops.scan")
    if not pathlib.Path(scan.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"yams_tpu_torch came from {scan.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E = clustered_corpus(1 << 20, 768, gen, dev)
    q = torch.nn.functional.normalize(torch.randn(1024, 768, generator=gen, device=dev), dim=1)
    q = q.to(torch.bfloat16)
    valid = torch.ones(E.shape[0], device=dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"script": "exact_topk_by_k", "tree": str(tree), "card": card,
           "shape": f"{E.shape[0]}x{E.shape[1]}, B={q.shape[0]}, block_rows 2048", "k": {}}
    for k in ks:
        kv, ki = scan.exact_topk_cuda(q, E, valid, k)
        tv, ti = scan.exact_topk_reference(q, E, valid, k)
        torch.cuda.synchronize()
        live = tv > -1e29
        out["k"][k] = {
            "ms": cuda_ms(lambda: scan.exact_topk_cuda(q, E, valid, k), reps),
            "plain_ms": cuda_ms(lambda: scan.exact_topk_reference(q, E, valid, k), 1),
            "max_abs_err": float((kv - tv).abs()[live].max()),
            "ids_differ": int(((ki != ti) & live).sum())}
        del kv, ki, tv, ti
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=pathlib.Path, default=HERE_TREE)
    ap.add_argument("--k", type=int, nargs="+", default=[10, 17, 100, 128])
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    print(json.dumps(run(a.tree, a.k, a.reps)))


if __name__ == "__main__":
    main()
