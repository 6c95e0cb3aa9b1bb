"""Where the time of the kernels on the shared mainloop (csrc/bf16_scan.cuh)
goes: K1, K2 and K3 against their own mainloop alone, and against dot_f32
(cuBLAS) on the same operands.

The kernel library is built twice: from csrc/ as it is, and from a copy
whose csrc/fused_scan.cu and csrc/exact_topk.cu stop each tile after the
mainloop (the accumulators are summed into a test that never holds, so
nothing is written). Both go into yams_tpu_torch/_build/. Each kernel is
timed with CUDA events at the shape its caller runs (profile_grouped:
1,003,520 x 768 unit-normal, B 256, group 256; exp_flash_topk: 1,015,808 x
768 clustered, B 1,024; K3 at the bench shape: 1,048,576 x 768 clustered,
B 1,024, k 10), in turns (as is, mainloop only, mainloop only, as is); the
epilogue's cost is the difference of the medians. Needs a card and nvcc.
Prints one JSON line.

    python -m yams_tpu_torch.scripts.fused_scan_split [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil

import numpy as np
import torch

from .. import _build
from ..device import resolve_device
from ..ops.flash_topk import windowed_scan_cuda
from ..ops.scan import dot_f32, exact_topk_cuda, grouped_max_cuda
from ._common import cuda_ms, device_name
from .exp_flash_topk import clustered_corpus
from .profile_grouped import unit_corpus

MARK = "      consume_tile(ring, c, p.k_slices, ct >> 7, acc);\n"
STUB = ("      {   // mainloop only: consume the accumulators, write nothing\n"
        "        float s = 0.f;\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < kAccRegs; ++i) s += acc[i];\n"
        "        if (s == 1234.5f) p.out_v[ct] = s;\n"
        "        continue;\n"
        "      }\n")


CUT = ("fused_scan.cu", "exact_topk.cu")   # the kernels on the shared mainloop


def mainloop_only_sources(dest: pathlib.Path) -> pathlib.Path:
    """A copy of csrc/ in dest whose mainloop kernels skip their epilogue."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(_build._SRC_DIR, dest)
    for name in CUT:
        f = dest / name
        src = f.read_text()
        if MARK not in src:
            raise RuntimeError(f"csrc/{name} no longer has the mainloop call this script cuts at")
        f.write_text(src.replace(MARK, MARK + STUB, 1))
    return dest


def run(reps: int = 20, device: str | torch.device = "cuda", seed: int = 0) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("fused_scan_split times the card's kernels: it needs a CUDA device")
    libs = {"as_is": _build.load(_build.build()),
            "mainloop_only": _build.load(_build.build(
                mainloop_only_sources(_build._BUILD_DIR / "mainloop_only_src")))}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E1 = unit_corpus(1_003_520, 768, gen, dev)
    q1 = torch.nn.functional.normalize(torch.randn(256, 768, generator=gen, device=dev), dim=1)
    q1 = q1.to(torch.bfloat16)
    v1 = torch.ones(E1.shape[0], device=dev)
    E2 = clustered_corpus(1_015_808, 768, 4096, 0.35, gen, dev)
    q2 = torch.nn.functional.normalize(torch.randn(1024, 768, generator=gen, device=dev), dim=1)
    q2 = q2.to(torch.bfloat16)
    b2 = torch.zeros(E2.shape[0], device=dev)
    E3 = clustered_corpus(1 << 20, 768, 4096, 0.35, gen, dev)
    v3 = torch.ones(E3.shape[0], device=dev)
    cases = {"grouped_max_cuda": (lambda: grouped_max_cuda(q1, E1, v1, 256), q1, E1),
             "windowed_scan_cuda": (lambda: windowed_scan_cuda(q2, E2, b2), q2, E2),
             "exact_topk_cuda": (lambda: exact_topk_cuda(q2, E3, v3, 10), q2, E3)}
    times = {name: {v: [] for v in libs} for name in cases}
    saved = _build._lib
    try:
        for variant in ("as_is", "mainloop_only", "mainloop_only", "as_is"):
            _build._lib = libs[variant]
            for name, (fn, _, _) in cases.items():
                times[name][variant].append(cuda_ms(fn, reps))
    finally:
        _build._lib = saved
    out = {"script": "fused_scan_split", "device": device_name(dev), "reps": reps, "kernels": {}}
    for name, (_, q, E) in cases.items():
        flops = 2.0 * q.shape[0] * E.shape[0] * E.shape[1]
        whole = float(np.median(times[name]["as_is"]))
        main = float(np.median(times[name]["mainloop_only"]))
        dot = cuda_ms(lambda: dot_f32(q, E), reps)
        out["kernels"][name] = {
            "shape": f"{E.shape[0]}x{E.shape[1]}, B={q.shape[0]}",
            "ms": times[name]["as_is"], "mainloop_only_ms": times[name]["mainloop_only"],
            "epilogue_ms": whole - main, "dot_f32_ms": dot,
            "tflops": flops / whole / 1e9, "mainloop_tflops": flops / main / 1e9,
            "dot_f32_tflops": flops / dot / 1e9}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    print(json.dumps(run(a.reps)))


if __name__ == "__main__":
    main()
