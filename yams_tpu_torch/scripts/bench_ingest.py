"""Ingest-throughput matrix: native pipeline across zstd level x chunk size
x threads, on compressible synthetic text.

Port of scripts/bench_ingest.py on the port's ingest library
(`native.ingest_pipeline`: FastCDC, SHA-256 and zstd in one C++ pass). It
produces the MB/s-per-core model of the host ingest tier and its thread
scaling. This is host code: nothing runs on a device, so it takes no
`--device`. Where the ingest library does not build (no `<zstd.h>`, as on
the card's machine) it says so and exits 1: no row is made up.

    python -m yams_tpu_torch.scripts.bench_ingest [size_mb]
"""

import os
import sys
import time

import numpy as np

from .. import native


def make_corpus(n_mb: int) -> bytes:
    """Realistic compressible text: zipfian word soup, ~3x zstd-compressible."""
    rng = np.random.default_rng(7)
    words = [f"word{i}" for i in range(4096)]
    zipf = rng.zipf(1.3, size=n_mb * 140_000)
    toks = [words[z % 4096] for z in zipf]
    out = (" ".join(toks)).encode()
    return out[: n_mb * 1024 * 1024]


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if native.ingest_library() is None:
        print("bench_ingest: the native ingest library did not build here "
              "(it needs g++ and <zstd.h>); no rows", file=sys.stderr)
        raise SystemExit(1)
    n_mb = int(argv[0]) if argv else 64
    data = make_corpus(n_mb)
    mb = len(data) / 1e6
    print(f"corpus: {mb:.0f} MB synthetic text, host cores={os.cpu_count()}")
    print(f"{'level':>5} {'avg_chunk':>9} {'threads':>7} {'MB/s':>8} "
          f"{'ratio':>6} {'chunks':>7}")
    results = {}
    for level in (0, -3, 1, 3):
        for avg in (64 * 1024, 256 * 1024, 1024 * 1024):
            for threads in (1, 2, 4):
                # warm + best-of-3
                best = 0.0
                for _ in range(3):
                    t0 = time.perf_counter()
                    res = native.ingest_pipeline(
                        data, avg // 4, avg, avg * 4,
                        level=level, threads=threads)
                    dt = time.perf_counter() - t0
                    best = max(best, mb / dt)
                comp = (sum(len(c[3]) for c in res) if level
                        else len(data)) or 1
                ratio = len(data) / comp
                results[(level, avg, threads)] = best
                print(f"{level:>5} {avg//1024:>8}K {threads:>7} {best:>8.0f} "
                      f"{ratio:>6.2f} {len(res):>7}")
    # the per-core model
    hot = results[(1, 256 * 1024, 1)]
    fast = results[(-3, 256 * 1024, 1)]
    print(f"\nper-core model: warm tier (L1, 256K chunks) = {hot:.0f} MB/s/core"
          f" -> >=1 GB/s needs {1000/hot:.1f} cores")
    print(f"per-core model: hot tier (zstd fast -3, 256K chunks, fused "
          f"1-thread pass) = {fast:.0f} MB/s/core "
          f"-> >=1 GB/s needs {1000/fast:.1f} cores")
    return results


if __name__ == "__main__":
    main()
