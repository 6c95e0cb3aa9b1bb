"""Checked-in benchmark baselines with regression tracking.

A copy of yams_tpu/utils/benchtrack.py (host code; the port imports nothing
of the JAX package).

Parity: tests/benchmarks/benchmark_tracker.h + baseline/*.json — metrics are
recorded to a baseline JSON on first run and compared (with slack) on later
runs, so perf regressions fail tests instead of rotting silently.
"""

from __future__ import annotations

import json
import pathlib
import platform
import time


class BenchmarkTracker:
    def __init__(self, baseline_path: str | pathlib.Path,
                 update_env: str = "YAMS_TPU_UPDATE_BASELINES"):
        self.path = pathlib.Path(baseline_path)
        self.update_env = update_env
        self._data: dict = {}
        if self.path.exists():
            try:
                self._data = json.loads(self.path.read_text())
            except json.JSONDecodeError:
                self._data = {}

    def record(
        self, name: str, value: float, unit: str,
        higher_is_better: bool = True, slack: float = 0.5,
    ) -> dict:
        """Record a measurement; returns {status, value, baseline, ratio}.

        status: 'new' (no baseline), 'ok', or 'regression' (worse than
        baseline by more than `slack` fraction).
        """
        import os

        entry = self._data.get(name)
        out = {"name": name, "value": value, "unit": unit, "baseline": None,
               "status": "new", "ratio": 1.0}
        if entry is not None:
            base = entry["value"]
            out["baseline"] = base
            if base > 0:
                ratio = value / base if higher_is_better else base / max(value, 1e-12)
                out["ratio"] = round(ratio, 3)
                out["status"] = "ok" if ratio >= (1.0 - slack) else "regression"
        if entry is None or os.environ.get(self.update_env):
            self._data[name] = {
                "value": value, "unit": unit,
                "higher_is_better": higher_is_better,
                "recorded_at": time.time(),
                "platform": platform.platform(),
            }
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(json.dumps(self._data, indent=1, sort_keys=True))
        return out
