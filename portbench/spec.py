"""BENCHMARK.json and the files it names, found by name.

A cell `<config>.<traffic>` is the workload entry of that name; its
configuration is the file the config entry names, its traffic mix
`mixes/<traffic>.json`, its correctness limits `limits/<cell>.json`, its
module `systems/<system>.py` (the `system` key of the configuration file),
and each metric it reports `metrics/<metric>.py`, a module whose
`read(run)` returns the metric's value or None where it finds nothing to
read. A metric split by what it moves (`<base>.<part>`, say
`device_idle_pct.bulk`) is read by `metrics/<base>.py` unless a file of its
own full name is there. Adding a cell, a mix or a metric is adding such
files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict       # the configuration file's contents
    mix: dict          # the traffic mix's contents
    limits: dict       # number name -> {"limit": ..., "lower": ..., "upper": ...}
    tie_eps: dict      # leg -> how far apart two exact scores may lie and tie
    end_to_end: list   # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """A metric without a `workloads` key is reported by every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, root: pathlib.Path = ROOT) -> CellSpec:
    bench = bench if bench is not None else benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    limits = load_json(HERE / "limits" / f"{name}.json")
    return CellSpec(
        name=name, chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        mix=load_json(HERE / "mixes" / f"{w['traffic']}.json"),
        limits={k: v for k, v in limits.items() if k not in ("tie_eps", "readings")},
        tie_eps=limits["tie_eps"],
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def system(config: dict):
    return importlib.import_module(f"portbench.systems.{config['system']}")


def reader(metric: str):
    """The module `metrics/<metric>.py`, or for a name `<base>.<part>` with
    no file of its own, the reader of `<base>` (names may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        return reader(metric.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
