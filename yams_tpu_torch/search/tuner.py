"""SearchTuner: runtime parameter tuning with a multi-armed bandit.

Copied from yams_tpu/search/tuner.py: the arms, UCB1 per corpus profile and
the JSON state file, which either package reads.

Parity: src/search/search_tuner.cpp + tuner MAB (search_engine.cpp:1455-1480
bandit-routed arms per corpus profile; rrfK clamps 8..80,
search_tuner.cpp:76-77). Arms are weight presets over the fusion config;
rewards come from user feedback (clicks / explicit relevance), UCB1 selection.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

from .config import SearchEngineConfig

RRF_K_MIN, RRF_K_MAX = 8, 80


@dataclasses.dataclass(slots=True)
class Arm:
    name: str
    text_weight: float
    vector_weight: float
    rrf_scale: float
    rrf_k: int
    # lexical strategy for the text leg (SimeonLexicalBackend bandit arms,
    # reference search_engine.cpp:1460-1480: sab_smooth / keyphrase /
    # lead_field alongside plain bm25). "" keeps the engine's configured arm.
    lexical_arm: str = ""

    def apply(self, cfg: SearchEngineConfig) -> SearchEngineConfig:
        return dataclasses.replace(
            cfg,
            text_weight=self.text_weight,
            vector_weight=self.vector_weight,
            rrf_scale=self.rrf_scale,
            rrf_k=max(RRF_K_MIN, min(RRF_K_MAX, self.rrf_k)),
            **({"lexical_arm": self.lexical_arm} if self.lexical_arm else {}),
        )


DEFAULT_ARMS = [
    Arm("balanced", 0.70, 0.30, 0.5, 12),       # reference defaults
    Arm("text_heavy", 0.85, 0.15, 0.4, 12),
    Arm("vector_heavy", 0.45, 0.55, 0.5, 12),
    Arm("rrf_heavy", 0.60, 0.40, 1.0, 20),
    # lexical-strategy arms: balanced fusion weights, forced lexical arm —
    # UCB1 learns per corpus profile whether a strategy beats routed "auto"
    Arm("lex_sab_smooth", 0.70, 0.30, 0.5, 12, lexical_arm="sab_smooth"),
    Arm("lex_keyphrase", 0.70, 0.30, 0.5, 12, lexical_arm="keyphrase"),
    Arm("lex_lead_field", 0.70, 0.30, 0.5, 12, lexical_arm="lead_field"),
]


class SearchTuner:
    """UCB1 bandit over fusion-weight arms, per corpus profile."""

    def __init__(self, arms: list[Arm] | None = None,
                 state_path: str | pathlib.Path | None = None):
        self.arms = arms or list(DEFAULT_ARMS)
        self.state_path = pathlib.Path(state_path) if state_path else None
        # profile -> per-arm (pulls, total_reward)
        self._stats: dict[str, list[list[float]]] = {}
        self._last_arm: dict[str, int] = {}
        if self.state_path and self.state_path.exists():
            try:
                self._stats = {
                    k: [list(x) for x in v]
                    for k, v in json.loads(self.state_path.read_text()).items()
                }
            except Exception:
                pass

    def _profile_stats(self, profile: str) -> list[list[float]]:
        if profile not in self._stats:
            self._stats[profile] = [[0.0, 0.0] for _ in self.arms]
        stats = self._stats[profile]
        # persisted state from a build with fewer arms: pad (new arms start
        # unpulled, which UCB1 explores first); extra rows are kept harmless
        while len(stats) < len(self.arms):
            stats.append([0.0, 0.0])
        return stats

    def select(self, profile: str = "default") -> tuple[int, Arm]:
        """UCB1: argmax mean + sqrt(2 ln T / n); unpulled arms first."""
        stats = self._profile_stats(profile)
        total = sum(s[0] for s in stats)
        best, best_score = 0, -1e30
        for i, (pulls, reward) in enumerate(stats):
            if pulls == 0:
                best = i
                break
            score = reward / pulls + math.sqrt(2.0 * math.log(max(total, 1)) / pulls)
            if score > best_score:
                best, best_score = i, score
        self._last_arm[profile] = best
        return best, self.arms[best]

    def record_reward(self, reward: float, profile: str = "default",
                      arm_index: int | None = None) -> None:
        stats = self._profile_stats(profile)
        idx = arm_index if arm_index is not None else self._last_arm.get(profile, 0)
        stats[idx][0] += 1
        stats[idx][1] += max(0.0, min(1.0, reward))
        self._save()

    def _save(self) -> None:
        if self.state_path:
            try:
                self.state_path.parent.mkdir(parents=True, exist_ok=True)
                self.state_path.write_text(json.dumps(self._stats))
            except OSError:
                pass

    def snapshot(self) -> dict:
        return {
            "arms": [a.name for a in self.arms],
            "stats": {
                p: [
                    {"arm": self.arms[i].name, "pulls": int(s[0]),
                     "mean_reward": (s[1] / s[0]) if s[0] else 0.0}
                    for i, s in enumerate(stats[: len(self.arms)])
                ]
                for p, stats in self._stats.items()
            },
        }


def corpus_profile(doc_count: int, avg_doc_len: float = 0.0) -> str:
    """Coarse corpus profiling bucket (the reference keys bandits this way)."""
    if doc_count < 1_000:
        return "small"
    if doc_count < 100_000:
        return "medium"
    return "large"
