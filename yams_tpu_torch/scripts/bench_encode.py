"""Simeon encode throughput vs the reference's NEON micro-baselines.

Port of scripts/bench_encode.py. Reference numbers (BASELINE.md,
darwin-arm64 NEON, 256 B docs):
  - hash-only sketch, 1024-d:               4.21 us/doc  (237k docs/s)
  - 384-d Achlioptas projection (4096 sk):  110.4 us/doc (9.1k docs/s)
  - 384-d very_sparse projection:           16.6 us/doc  (60.4k docs/s)

This measures the port's split pipeline on the same document shape:
  host sketch (tokenize + hashed n-grams: embed/simeon.py `sketch_texts`,
    the native C++ sketch library where it builds, else NumPy)
  device projection (the bf16 sketch @ the seeded sign matrix with an f32
    result, `dot_f32`, then the row norm; on the card unless --device cpu)
and reports docs/s for (a) sketch only, (b) projection only at saturating
batch (host sketch in, host embeddings out, as the reference's jitted
call), (c) end to end: sketch, upload, projection, download.

    python -m yams_tpu_torch.scripts.bench_encode [--docs N] [--bytes B] [--reps R]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.config import EmbeddingConfig
from ..device import resolve_device
from ..embed.provider import native_sketch_available, projection_host
from ..embed.simeon import sketch_texts
from ..ops.scan import dot_f32

WORDS = (
    "storage engine search vector index daemon chunk hash embed query graph "
    "metadata repair snapshot session topology cluster fusion lexical scan "
    "postings impact recall latency throughput shard mesh collective kernel "
    "compile trace buffer socket protocol stream batch token sketch project"
).split()


def make_docs(n: int, target_bytes: int, seed: int = 7) -> list[str]:
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        parts: list[str] = []
        size = 0
        while size < target_bytes:
            w = WORDS[int(rng.integers(len(WORDS)))]
            parts.append(w)
            size += len(w) + 1
        docs.append(" ".join(parts))
    return docs


def projector(cfg: EmbeddingConfig, dev: torch.device):
    """host (B, S) f32 sketch -> host (B, D) f32 unit rows, projected on dev."""
    R_t = torch.from_numpy(projection_host(cfg)).t().contiguous().to(dev, torch.bfloat16)

    def project(sk: np.ndarray) -> np.ndarray:
        x = dot_f32(torch.from_numpy(sk).to(dev), R_t)
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        return x.cpu().numpy()

    return project


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=4096)
    ap.add_argument("--bytes", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = EmbeddingConfig()
    docs = make_docs(args.docs, args.bytes)

    # (a) host sketch only
    sketch_texts(docs[:64], cfg)  # warm the token-hash lru cache
    best = 0.0
    for _ in range(args.reps):
        t0 = time.perf_counter()
        sk = sketch_texts(docs, cfg)
        dt = time.perf_counter() - t0
        best = max(best, args.docs / dt)
    print(f"host sketch ({cfg.sketch_dim}-d, {args.bytes} B docs, "
          f"{'native' if native_sketch_available() else 'numpy'}): "
          f"{best:,.0f} docs/s  ({1e6 / best:.1f} us/doc)")

    # (b) device projection only, saturating batch
    project = projector(cfg, dev)
    project(sk)
    bestp = 0.0
    for _ in range(args.reps):
        t0 = time.perf_counter()
        project(sk)
        dt = time.perf_counter() - t0
        bestp = max(bestp, args.docs / dt)
    print(f"device projection ({cfg.sketch_dim}->{cfg.dim} on {dev}, B={args.docs}): "
          f"{bestp:,.0f} docs/s  ({1e6 / bestp:.2f} us/doc)")

    # (c) end to end
    beste = 0.0
    for _ in range(args.reps):
        t0 = time.perf_counter()
        out = project(sketch_texts(docs, cfg))
        dt = time.perf_counter() - t0
        beste = max(beste, args.docs / dt)
    print(f"end-to-end encode ({cfg.dim}-d): {beste:,.0f} docs/s  "
          f"({1e6 / beste:.1f} us/doc)")
    print("reference NEON baselines: hash-only 237k docs/s; "
          "384-d Achlioptas 9.1k docs/s; very_sparse 60.4k docs/s")
    return {"sketch_docs_s": best, "projection_docs_s": bestp, "encode_docs_s": beste,
            "embeddings": out}


if __name__ == "__main__":
    main()
