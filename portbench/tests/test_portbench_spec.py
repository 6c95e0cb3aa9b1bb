"""BENCHMARK.json and the files it names: every cell loads by name, every
name keeps to the benchmark's rules, and nothing of the harness imports
JAX, the JAX package or the root bench.py."""

from __future__ import annotations

import ast
import json
import pathlib
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_has_exactly_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_one_line_texts():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200 and c["file"].startswith("portbench/")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_bounds_and_the_metrics_every_cell_reports():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if spec.reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(spec.reports(m, cell) for m in BENCH["per_layer"]), cell


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.cell(cell)
    assert c.chips == 1
    assert c.config["name"] == cell.split(".")[0] and c.config["reduced"] == []
    assert c.mix["batch"] > 0 and c.mix["loop"] == "closed" and c.mix["in_flight"] == 1
    assert set(c.limits) == {"vec_gap", "bm25_gap", "fused_gap", "fused_miss"}
    for lim in c.limits.values():
        assert lim["lower"] < lim["limit"] < lim["upper"], (cell, lim)
        assert lim["limit"] / lim["lower"] > lim["upper"] / lim["limit"] or lim["lower"] == 0
    assert set(c.tie_eps) == {"vec", "bm25"}
    assert spec.system(c.config).Cell


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric).read)


def test_config_files_belong_to_one_config_each():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        data = spec.load_json(spec.ROOT / c["file"])
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    top = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            top.add(node.module.split(".")[0])
    return top


@pytest.mark.parametrize("path", sorted(spec.HERE.rglob("*.py")), ids=lambda p: p.name)
def test_nothing_imports_jax_the_jax_package_or_bench(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "yams_tpu", "bench"}


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "dataclasses", "torch"}


@pytest.mark.parametrize("metric", ["device_idle_pct.bulk", "hybrid_query_roofline.interactive"])
def test_a_split_metric_is_read_by_its_base_reader(metric):
    base = metric.rsplit(".", 1)[0]
    assert not (spec.HERE / "metrics" / f"{metric}.py").exists()
    assert spec.reader(metric).read is spec.reader(base).read


@pytest.mark.parametrize("mix", sorted(p.stem for p in (spec.HERE / "mixes").glob("*.json")))
def test_term_counts_follow_the_law_the_mix_names(mix):
    q = spec.load_json(spec.HERE / "mixes" / f"{mix}.json")["query"]
    law = q.get("term_count_law")
    if law is None:
        pytest.skip(f"mix {mix} names no law for its term counts")
    assert law["law"] == "geometric" and law["cap"] == q["max_terms"]
    p = 1.0 / law["mean_words"]
    want = [p * (1 - p) ** (n - 1) for n in range(1, law["cap"])] + [(1 - p) ** (law["cap"] - 1)]
    got = q["term_count_weights"]
    assert [w / sum(got) for w in got] == pytest.approx(want, abs=1e-6)
