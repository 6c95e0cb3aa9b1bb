"""Which side holds the SHA-256 kernel (csrc/sha256.cu): its round warp or
its helper warps.

The kernel library is built three times: from csrc/ as it is, from a copy
whose round warp skips the compression (it still waits for each block's
schedule, reads it and frees the slot, so what is left is the helpers'
copies and schedules), and from a copy whose helpers skip the copy (they
build each block's words from whatever shared memory holds, so what is
left is the schedules and the rounds, with no device-memory traffic). Each
goes into yams_tpu_torch/_build/. The kernel's launch alone is timed with
CUDA events on the chunks of `mb` MiB of seeded zipf-word text, cut by the
device chunker at the ingest defaults (smoke phase 2's set), in turns (as
is, then each copy, then each copy again in the reverse order, then as is),
beside the chain floor: the longest chunk alone, as its own launch, and the
cycles a round it gives at the SM clock nvidia-smi reads. Needs a card and
nvcc. Prints one JSON line.

    python -m yams_tpu_torch.scripts.sha256_split [--mb 128] [--reps 5]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import shutil

import numpy as np
import torch

from .. import _build
from ..core.config import ChunkingConfig
from ..device import resolve_device
from ..ingest.device_pipeline import payload_tensor
from ..ops import sha256
from ..ops.cdc import boundaries_device
from ._common import card_line, cuda_ms, sm_clock_mhz, zipf_text

ROUNDS_MARK = "      compress(v, &s.sched[slot][0][lane]);\n"
ROUNDS_STUB = ("      {   // rounds skipped: fold the block's W + K into the state\n"
               "        const uint4* wk = &s.sched[slot][0][lane];\n"
               "#pragma unroll\n"
               "        for (int q = 0; q < 16; ++q) v[q & 7] ^= wk[q * kLanes].x ^ wk[q * kLanes].w;\n"
               "      }\n")
COPY_MARK = "  if (off >= len) return;   // nothing of the message in this span (the padding needs none)\n"
# variant -> (the line it cuts at, what replaces that line)
VARIANTS = {"rounds_skipped": (ROUNDS_MARK, ROUNDS_STUB),
            "copies_skipped": (COPY_MARK, "  return;   // copies skipped\n" + COPY_MARK)}


def variant_sources(dest: pathlib.Path, variant: str) -> pathlib.Path:
    """A copy of csrc/ in dest whose sha256.cu has `variant`'s cut."""
    mark, cut = VARIANTS[variant]
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(_build._SRC_DIR, dest)
    f = dest / "sha256.cu"
    src = f.read_text()
    if src.count(mark) != 1:
        raise RuntimeError(f"csrc/sha256.cu no longer has the line this script cuts at: {mark!r}")
    f.write_text(src.replace(mark, cut, 1))
    return dest


def run(mb: float = 128, reps: int = 5, device: str | torch.device = "cuda",
        seed: int = 0) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("sha256_split times the card's kernel: it needs a CUDA device")
    libs = {"as_is": _build.load(_build.build())}
    for v in VARIANTS:
        libs[v] = _build.load(_build.build(
            variant_sources(_build._BUILD_DIR / f"sha256_{v}_src", v)))
    data = zipf_text(int(mb * (1 << 20)), seed)
    buf = payload_tensor(data, dev)
    c = ChunkingConfig()
    ends = np.asarray(boundaries_device(buf, c.min_size, c.avg_size, c.max_size), np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    lengths = (ends - starts).astype(np.int32)
    st, ln = torch.from_numpy(starts).to(dev), torch.from_numpy(lengths).to(dev)
    order = sha256.block_order(ln)
    out = torch.empty((len(lengths), 32), dtype=torch.uint8, device=dev)
    i = int(lengths.argmax())
    one = (st[i:i + 1], ln[i:i + 1], torch.zeros(1, dtype=torch.int64, device=dev),
           torch.empty((1, 32), dtype=torch.uint8, device=dev))
    times = {v: [] for v in libs}
    saved = _build._lib
    try:
        for variant in ("as_is", *VARIANTS, *reversed(VARIANTS), "as_is"):
            _build._lib = libs[variant]
            times[variant].append(cuda_ms(lambda: sha256.launch(buf, st, ln, order, out), reps))
        _build._lib = libs["as_is"]
        sha256.launch(buf, st, ln, order, out)
        digests = out.cpu().numpy()
        chain = cuda_ms(lambda: sha256.launch(buf, *one), reps)
        mhz = sm_clock_mhz(lambda: sha256.launch(buf, *one))
    finally:
        _build._lib = saved
    ok = all(digests[j].tobytes() == hashlib.sha256(data[s:e]).digest()
             for j, (s, e) in enumerate(zip(starts, ends)))
    med = {v: float(np.median(t)) for v, t in times.items()}
    rounds = (int(lengths.max()) + 9 + 63) // 64 * 64
    return {"script": "sha256_split", "card": card_line(dev), "reps": reps,
            "payload_bytes": len(data), "chunks": len(lengths),
            "longest_chunk_blocks": rounds // 64, "digests_equal_hashlib": ok,
            "ms": times, "median_ms": med, "chain_ms": chain, "over_chain": med["as_is"] / chain,
            "sm_clock_mhz": mhz,
            "cycles_per_round": {v: ms * 1e-3 * mhz * 1e6 / rounds for v, ms in med.items()}
            | {"chain": chain * 1e-3 * mhz * 1e6 / rounds}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=128)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    print(json.dumps(run(a.mb, a.reps)))


if __name__ == "__main__":
    main()
