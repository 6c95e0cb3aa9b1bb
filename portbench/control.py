"""Readings that the correctness limits are set from, at a cell's own size.

    python -m portbench.control --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--out FILE]

For each seed, in one process: the cell is built and warmed as a run builds
it, one pass over its query pool is served (as many requests as a run's
sample draws from, at the cell's own batch), and a sample drawn from the
seed is judged, as a run judges it: the program's readings. For each
control seed the same queries are answered by the control instead (the
reference one precision step below the configuration's, see
`reference/hybrid.py`) and judged the same way: readings that must fail.
Each seed prints one JSON line (also appended to FILE). A number's lower
reading is the largest the program gives over a dozen seeds or more, its
upper reading the smallest the control gives; its limit lies between
(limits/<cell>.json). Needs a card; the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import run, spec


def readings(cell: spec.CellSpec, seed: int, control: bool, device, engine=None) -> dict:
    import torch

    sut = spec.system(cell.config).Cell(cell.config, cell.mix, seed, device, engine)
    sut.warm(cell.mix["warm_requests"])
    answers = [sut.request(i) for i in range(sut.n_batches)]
    sample = sut.sample(list(range(len(answers))))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out = {"seed": seed, "sample": sample}
    out["program"], out["queries"] = sut.judge(answers, sample, cell.tie_eps)
    out["reference_s"] = time.perf_counter() - t
    if control:
        out["control"], _ = sut.judge(answers, sample, cell.tie_eps, precision="lower")
    del sut, answers
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    run.pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {run.card_identity()}; torch {torch.__version__}", flush=True)
    for seed in args.seeds:
        r = readings(cell, seed, seed in args.control_seeds, torch.device("cuda", 0))
        r["workload"] = cell.name
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
