"""Topological data analysis utilities: H_0 persistence for cluster quality.

Rebuilds the reference's topological_quality (include/yams/search/
topological_quality.h, src/search/topological_quality.cpp): the sum of H_0
birth/death lifetimes of the Vietoris-Rips filtration equals the total MST
edge weight (every point is born at r=0; each component merge is a death at
the edge's distance; the final essential class is skipped). The reference
normalizes by the 95th-percentile pairwise distance rather than the max
(on unit-norm text embeddings the max is near-constant ~sqrt(2)); kept here.

Used the same way: TopologyManager.cpp:703 computes centroid persistence
after each rebuild and feeds it to the topology tuner's reward. Here the
TopologyEngine stamps it into TopologyArtifacts.centroid_persistence.

Prim's algorithm over the dense distance matrix is O(n^2) time / O(n^2)
memory — cheaper than the reference's sort of ~n^2/2 edges, and n is small
(cluster centroids, subsampled to <= max_points).

Copied from yams_tpu/utils/tda.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import numpy as np


def deterministic_subsample(total: int, max_count: int, seed: int = 0) -> np.ndarray:
    """Reproducible subset of row indices (reference: deterministicSubsample).

    Identity permutation when total <= max_count; otherwise a seeded
    without-replacement draw, sorted for cache-friendly gathers.
    """
    if total <= max_count:
        return np.arange(total, dtype=np.int64)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(total, size=max_count, replace=False))


def persistence_h0(
    embeddings: np.ndarray, max_points: int = 256, seed: int = 0
) -> float:
    """Sum of H_0 lifetimes (== MST total weight) / p95 pairwise distance.

    Returns 0.0 for degenerate inputs (<2 points or all-coincident points).
    Higher values mean more spread-out / less collapsed cluster structure.
    """
    X = np.asarray(embeddings, dtype=np.float32)
    if X.ndim != 2 or len(X) < 2:
        return 0.0
    if len(X) > max_points:
        X = X[deterministic_subsample(len(X), max_points, seed)]
    n = len(X)
    sq = np.einsum("ij,ij->i", X, X)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
    D = np.sqrt(np.maximum(d2, 0.0))
    # Prim's MST from node 0
    in_tree = np.zeros(n, dtype=bool)
    in_tree[0] = True
    dist = D[0].copy()
    dist[0] = np.inf
    total = 0.0
    for _ in range(n - 1):
        j = int(np.argmin(dist))
        total += float(dist[j])
        in_tree[j] = True
        np.minimum(dist, D[j], out=dist)
        dist[in_tree] = np.inf
    iu = np.triu_indices(n, k=1)
    p95 = float(np.percentile(D[iu], 95))
    if p95 <= 1e-12:
        return 0.0
    return total / p95
