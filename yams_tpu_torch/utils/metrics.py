"""Retrieval-quality metrics: MRR / nDCG@k / recall@k / precision@k.

Parity: the BEIR-style evaluation in tests/benchmarks/search/
retrieval_quality_bench.cpp (MRR 0.613 / nDCG 0.634 / recall@10 0.713 on
scifact per BASELINE.md).

Copied from yams_tpu/utils/metrics.py (the port imports nothing of
yams_tpu): past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py).
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def reciprocal_rank(ranked: Sequence, relevant: set) -> float:
    for i, doc in enumerate(ranked, 1):
        if doc in relevant:
            return 1.0 / i
    return 0.0


def recall_at_k(ranked: Sequence, relevant: set, k: int = 10) -> float:
    if not relevant:
        return 0.0
    hits = sum(1 for d in ranked[:k] if d in relevant)
    return hits / min(len(relevant), k)


def precision_at_k(ranked: Sequence, relevant: set, k: int = 10) -> float:
    if k == 0:
        return 0.0
    return sum(1 for d in ranked[:k] if d in relevant) / k


def ndcg_at_k(ranked: Sequence, relevant: set, k: int = 10) -> float:
    dcg = sum(
        1.0 / math.log2(i + 1)
        for i, d in enumerate(ranked[:k], 1) if d in relevant
    )
    ideal = sum(1.0 / math.log2(i + 1) for i in range(1, min(len(relevant), k) + 1))
    return dcg / ideal if ideal > 0 else 0.0


def evaluate(
    runs: Iterable[tuple[Sequence, set]], k: int = 10
) -> dict[str, float]:
    """runs: [(ranked doc ids, relevant set)] -> aggregate metrics."""
    mrr = rec = ndcg = prec = 0.0
    n = 0
    for ranked, relevant in runs:
        mrr += reciprocal_rank(ranked, relevant)
        rec += recall_at_k(ranked, relevant, k)
        ndcg += ndcg_at_k(ranked, relevant, k)
        prec += precision_at_k(ranked, relevant, k)
        n += 1
    if n == 0:
        return {"mrr": 0.0, "recall": 0.0, "ndcg": 0.0, "precision": 0.0, "n": 0}
    return {
        "mrr": mrr / n, "recall": rec / n, "ndcg": ndcg / n,
        "precision": prec / n, "n": n,
    }
