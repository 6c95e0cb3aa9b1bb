"""Topology construction and query-time cluster routing, on a torch device.

Port of yams_tpu/index/topology.py: clusters over the vector index
(k-means, connected components of the similarity kNN graph, or one level of
Louvain), each with centroids, bounded routing representatives and an
epoch, and the per-query routing the engine's narrow, augment and shadow
policies read.

The reference's device functions are torch functions on the device of the
tensors they are given:

  - `kmeans_assign`: the bf16 product with f32 scores (`ops.scan.dot_f32`),
    the first maximum, invalid rows -> (-1, 0.0);
  - `kmeans_step`: one Lloyd step. The segment sums are deterministic:
    rows sorted by cluster (a stable sort) and summed in row order, in
    pieces of 64 rows and then the pieces in order (`torch.segment_reduce`),
    never float atomics, so two builds of one index on the card are
    bit-identical;
  - `knn_graph` + `propagate_labels` (= `connected_labels`): the kNN
    self-join over `ops.scan.exact_topk_scan` (`knn_live`: the live rows
    alone, in query slices), sub-threshold edges replaced by self edges
    (`knn_edges`), then label propagation
    (forward gather-min, backward scatter-min that keeps the current value,
    path halving). Louvain's graph comes from `knn_live` too.

`TopologyEngine(..., device=)` runs those steps on its device. It takes the
host f32 vectors, as the reference does, and uploads them once a build.
The rest is host NumPy, copied from the reference line for line
(`auto_k`, `TopologyArtifacts`, `RouteSelection`, `pick_representatives`,
`build_auto`, `cluster_scores`, `select_routes`, `route`, `member_rows`,
`routed_row_mask`, `TopologyTuner`; tests/test_torch_host_copies.py), with
one change of form: the builds' packaging (dense cluster ids, centroids,
sizes, cohesion) takes each cluster's members from one stable sort of the
assignments instead of a scan of every row for every cluster. The members,
their order and so every number are the reference's; the cost is
O(N log N) instead of O(N * K). Each build records its stage times in
`last_timings` (seconds).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.scan import dot_f32, exact_topk_scan


def auto_k(n_docs: int) -> int:
    """Reference: topology_artifacts.h:90-101."""
    if n_docs <= 1:
        return 1
    return max(min(64, n_docs), min(300, int(np.sqrt(n_docs))))


def kmeans_assign(vectors: torch.Tensor, valid: torch.Tensor,
                  centroids: torch.Tensor):
    """Assignment step: cosine similarity argmax -> (assign (N,) i32, best
    (N,) f32); invalid rows get (-1, 0.0). torch.argmax keeps the first
    maximum, as jnp.argmax does."""
    sims = dot_f32(vectors, centroids)
    assign = sims.argmax(dim=1).to(torch.int32)
    best = sims.amax(dim=1)
    ok = valid > 0
    return torch.where(ok, assign, -1), torch.where(ok, best, torch.zeros_like(best))


_PIECE = 64   # rows a first-level partial sum of the segment sums covers


def _segment_plan(seg: torch.Tensor, num_segments: int):
    """The fixed summation order of `segment_sum`: (the rows whose segment
    lies in [0, num_segments), sorted by segment by a stable sort; each
    _PIECE-row piece's length; each segment's number of pieces)."""
    seg = seg.long()
    order = torch.sort(seg, stable=True).indices
    lengths = torch.bincount(seg.clamp(0, num_segments), minlength=num_segments + 1)
    lengths = lengths[:num_segments]
    pieces = (lengths + _PIECE - 1) // _PIECE
    n_rows, n_pieces = (int(x) for x in torch.stack([lengths.sum(), pieces.sum()]).tolist())
    first = torch.cumsum(pieces, 0) - pieces
    piece_seg = torch.repeat_interleave(torch.arange(num_segments, device=seg.device),
                                        pieces, output_size=n_pieces)
    within = torch.arange(n_pieces, device=seg.device) - first[piece_seg]
    piece_len = torch.clamp(lengths[piece_seg] - within * _PIECE, max=_PIECE)
    return order[:n_rows], piece_len, pieces


def _segment_apply(rows: torch.Tensor, piece_len: torch.Tensor,
                   pieces: torch.Tensor) -> torch.Tensor:
    partial = torch.segment_reduce(rows, "sum", lengths=piece_len, axis=0)
    return torch.segment_reduce(partial, "sum", lengths=pieces, axis=0)


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum of (N, C) rows without float atomics, so the
    result is the same on every run: the rows sorted by segment (a stable
    sort), each segment's rows summed in row order in pieces of _PIECE
    rows, then each segment's pieces in order (two `torch.segment_reduce`
    passes). Rows whose segment lies outside [0, num_segments) are dropped,
    as jax.ops.segment_sum drops them; an empty segment sums to 0."""
    rows, piece_len, pieces = _segment_plan(seg, num_segments)
    return _segment_apply(data.index_select(0, rows), piece_len, pieces)


def kmeans_step(vectors: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd iteration: assign + masked mean update + renormalize.

    Invalid rows go to a sink segment K, which the sums drop. Empty
    clusters keep their previous centroid."""
    K = centroids.shape[0]
    assign, _ = kmeans_assign(vectors, valid, centroids)
    rows, piece_len, pieces = _segment_plan(torch.where(assign < 0, K, assign), K)
    # segment_sum(vectors * valid) and segment_sum(valid) on one plan, the
    # rows gathered before they are weighted
    w = valid.index_select(0, rows)
    sums = _segment_apply(vectors.index_select(0, rows).mul_(w[:, None]), piece_len, pieces)
    counts = _segment_apply(w[:, None], piece_len, pieces)[:, 0]
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts[:, None], min=1), centroids)
    norm = torch.linalg.vector_norm(new, dim=1, keepdim=True)
    new = new / torch.clamp(norm, min=1e-9)
    return new, assign, counts


@dataclasses.dataclass
class TopologyArtifacts:
    """Cluster artifacts (reference: TopologyArtifactBatch)."""

    centroids: np.ndarray        # (K, D) f32, unit norm
    assignments: np.ndarray      # (rows,) i32, -1 for invalid rows
    cluster_sizes: np.ndarray    # (K,)
    epoch: int
    cohesion: np.ndarray         # (K,) mean member similarity to centroid
    # H_0 persistence of the centroid cloud (reference: TopologyManager.cpp:703
    # clusterCentroidPersistence — the rebuild-quality signal for the tuner)
    centroid_persistence: float = 0.0
    # bounded per-cluster routing representatives (reference:
    # topology_artifacts.h representative cover +
    # topologyRoutingRepresentativeLimit): the R members most similar to
    # their centroid, stored as vectors so routing stays self-contained
    # across index mutations. A centroid is a poor stand-in for an
    # elongated or multi-lobed cluster; scoring the query against the reps
    # too catches members a centroid matmul would under-rank.
    rep_vectors: np.ndarray | None = None   # (K, R, D) f32, zero-padded
    rep_counts: np.ndarray | None = None    # (K,) i32 live reps per cluster

    def __post_init__(self):
        if not self.centroid_persistence and len(self.centroids) >= 2:
            from ..utils.tda import persistence_h0

            self.centroid_persistence = persistence_h0(self.centroids)


@dataclasses.dataclass
class RouteSelection:
    """One query's routing decision + its certificate metadata (reference:
    TopologyRoutingSessionResult route work/abstention fields)."""

    clusters: np.ndarray         # selected cluster ids, best first
    scores: np.ndarray           # blended route scores, aligned to clusters
    boundary_margin: float       # score gap selected/excluded (inf if all)
    abstained: bool              # margin below the narrow gate -> full scan
    rows_routed: int             # total member rows in the selection
    budget_clamped: bool         # work budget dropped trailing clusters


def pick_representatives(
    vectors: np.ndarray, valid: np.ndarray, assignments: np.ndarray,
    centroids: np.ndarray, r: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Top-r members per cluster by centroid similarity -> (K,r,D), (K,).

    One O(N*D) pass: each live row's similarity to ITS OWN centroid, then a
    per-cluster argsort of members only (no (N,K) matrix)."""
    K, D = centroids.shape
    reps = np.zeros((K, r, D), np.float32)
    counts = np.zeros(K, np.int32)
    if r <= 0 or not len(vectors):
        return reps, counts
    live = (valid > 0) & (assignments >= 0)
    rows = np.nonzero(live)[0]
    if not len(rows):
        return reps, counts
    a = assignments[rows]
    sims = np.einsum("nd,nd->n", vectors[rows].astype(np.float32),
                     centroids[a])
    order = np.lexsort((-sims, a))   # group by cluster, best-first inside
    rows, a, sims = rows[order], a[order], sims[order]
    starts = np.searchsorted(a, np.arange(K))
    ends = np.searchsorted(a, np.arange(K) + 1)
    for c in range(K):
        m = rows[starts[c]:ends[c]][:r]
        if len(m):
            reps[c, : len(m)] = vectors[m]
            counts[c] = len(m)
    return reps, counts


_KNN_QUERIES = 16_384   # query rows a slice of the kNN self-join takes


def knn_live(vectors: torch.Tensor, valid: torch.Tensor, k: int, block_rows: int,
             query_rows: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact kNN self-join (f32 queries, bf16 products, f32 scores) of
    the live rows over the live rows -> ((N, k) values, (N, k) row ids);
    an invalid row's list is (-1e30, -1).

    The reference runs exact_topk_scan over every row. Its dead columns
    score -1e30, below any live score, and the live columns keep their
    order, so ties keep theirs: a live row's list here is the reference's
    up to the summation order of its products. The dead rows' lists, which
    no caller reads, are left out: their all-equal scores would send each
    merge into the tie-repair path. The live queries go in slices of
    `query_rows` rows (_KNN_QUERIES by default), which bounds the scores
    block; a slice's shape can change only the summation order.
    tests/test_torch_topology.py holds the sliced lists and the builds on
    them to the reference on the CPU, and chip_smoke.py holds the sliced
    join to one slice of the same rows on the card."""
    N = vectors.shape[0]
    dev = vectors.device
    live = torch.nonzero(valid > 0).flatten()
    n = live.numel()
    vals = torch.full((N, k), -1e30, dtype=torch.float32, device=dev)
    nbrs = torch.full((N, k), -1, dtype=torch.int64, device=dev)
    if not n:
        return vals, nbrs
    step = query_rows or _KNN_QUERIES
    pad = (-n) % block_rows
    corpus = torch.nn.functional.pad(vectors.index_select(0, live), (0, 0, 0, pad))
    ok = torch.nn.functional.pad(torch.ones(n, device=dev), (0, pad))
    for lo in range(0, n, step):
        q = corpus[lo:min(n, lo + step)].float()
        v, i = exact_topk_scan(q, corpus, ok, k=k, block_rows=block_rows)
        i = i.long()
        rows = live[lo:lo + q.shape[0]]
        vals[rows] = v
        nbrs[rows] = torch.where(i >= 0, live[i.clamp(min=0)], -1)
    return vals, nbrs


def knn_edges(vals: torch.Tensor, nbrs: torch.Tensor, valid: torch.Tensor,
              min_edge_score: float) -> torch.Tensor:
    """A kNN self-join's lists as the similarity graph's (N, knn) int64
    neighbor rows; an edge under min_edge_score, to no row, or from an
    invalid row is replaced by a self edge."""
    edge_ok = (vals >= min_edge_score) & (nbrs >= 0) & (valid[:, None] > 0)
    self_idx = torch.arange(nbrs.shape[0], device=nbrs.device)[:, None]
    return torch.where(edge_ok, nbrs, self_idx)


def knn_graph(vectors: torch.Tensor, valid: torch.Tensor, min_edge_score: float,
              knn: int = 8, block_rows: int = 1024) -> torch.Tensor:
    """The similarity kNN graph (self included), `knn_edges` of `knn_live`."""
    vals, nbrs = knn_live(vectors, valid, knn, block_rows)
    return knn_edges(vals, nbrs, valid, min_edge_score)


def propagate_labels(nbrs: torch.Tensor, lp_iters: int = 24) -> torch.Tensor:
    """Connected-component labels over a directed kNN graph: `lp_iters`
    rounds of a forward gather-min, a backward scatter-min (which keeps the
    current value, as `.at[].min` does) and path halving (labels[labels])."""
    N, knn = nbrs.shape
    labels = torch.arange(N, device=nbrs.device)
    flat = nbrs.reshape(-1)
    for _ in range(lp_iters):
        fwd = torch.minimum(labels, labels[nbrs].amin(dim=1))
        labels = fwd.scatter_reduce(0, flat, fwd.repeat_interleave(knn),
                                    reduce="amin", include_self=True)
        labels = labels[labels]
    return labels.to(torch.int32)


def connected_labels(vectors: torch.Tensor, valid: torch.Tensor,
                     min_edge_score: float, knn: int = 8,
                     block_rows: int = 1024, lp_iters: int = 24) -> torch.Tensor:
    """Connected-components labels over the similarity kNN graph (rows
    padded to a block multiple); invalid rows label themselves."""
    return propagate_labels(
        knn_graph(vectors, valid, min_edge_score, knn, block_rows), lp_iters)


def _sync(device: torch.device) -> None:
    """Wait for the device, so a stage's host time includes its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _members(assign: np.ndarray, K: int):
    """Each cluster's rows in ascending order, from one stable sort:
    (order, starts, ends) with cluster c's rows order[starts[c]:ends[c]],
    the rows `np.nonzero(assign == c)` gives."""
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    starts = np.searchsorted(sa, np.arange(K))
    ends = np.searchsorted(sa, np.arange(K), side="right")
    return order, starts, ends


def _centroids_of(vectors: np.ndarray, assign: np.ndarray, next_id: int):
    """The reference's packaging of a labelled build: (centroids, sizes,
    cohesion) of clusters 0..next_id-1 (at least one row of zeros)."""
    K = max(next_id, 1)
    centroids = np.zeros((K, vectors.shape[1]), np.float32)
    sizes = np.zeros(K, np.int64)
    cohesion = np.zeros(K, np.float32)
    order, starts, ends = _members(assign, next_id)
    for c in range(next_id):
        members = vectors[order[starts[c]:ends[c]]]
        sizes[c] = len(members)
        if len(members):
            mean = members.mean(axis=0)
            norm = np.linalg.norm(mean)
            centroids[c] = mean / norm if norm > 0 else mean
            cohesion[c] = float((members @ centroids[c]).mean())
    return centroids, sizes, cohesion


class TopologyEngine:
    """Builds artifacts from the vector index; routes queries to clusters."""

    def __init__(self, iters: int = 8, seed: int = 0,
                 representatives: int = 4, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.iters = iters
        self.seed = seed
        self.representatives = representatives
        self.artifacts: TopologyArtifacts | None = None
        self.last_timings: dict[str, float] = {}

    def _attach_reps(self, vectors: np.ndarray, valid: np.ndarray) -> None:
        a = self.artifacts
        if a is not None and self.representatives > 0:
            a.rep_vectors, a.rep_counts = pick_representatives(
                vectors, valid, a.assignments, a.centroids,
                self.representatives,
            )

    def _upload(self, vectors: np.ndarray, valid: np.ndarray, pad: int = 0):
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        m = valid.astype(np.float32)
        if pad:
            v = np.pad(v, ((0, pad), (0, 0)))
            m = np.pad(m, (0, pad))
        return (torch.from_numpy(v).to(self.device),
                torch.from_numpy(m).to(self.device))

    def _finish(self, vectors, valid, centroids, assign, sizes, epoch,
                cohesion, t0: float) -> TopologyArtifacts:
        self._member_csr = None
        self.artifacts = TopologyArtifacts(centroids, assign, sizes, epoch, cohesion)
        self._attach_reps(vectors, valid)
        self.last_timings["package_s"] = time.perf_counter() - t0
        return self.artifacts

    def build_connected(
        self, vectors: np.ndarray, valid: np.ndarray, epoch: int = 0,
        min_edge_score: float = 0.25, max_component_docs: int = 64,
        knn: int = 8,
    ) -> TopologyArtifacts:
        """The reference's default Connected engine (min_edge_score=0.25,
        max_component_docs=64): device kNN graph + label propagation, then
        host component packaging with size capping."""
        self.last_timings = {}
        n = len(vectors)
        block = 256
        v, m = self._upload(vectors, valid, (-n) % block)
        t0 = time.perf_counter()
        nbrs = knn_graph(v, m, min_edge_score, knn=min(knn, max(n, 2)),
                         block_rows=block)
        _sync(self.device)
        t1 = time.perf_counter()
        labels = propagate_labels(nbrs).cpu().numpy()[:n]
        t2 = time.perf_counter()
        self.last_timings.update(knn_s=t1 - t0, propagate_s=t2 - t1)
        labels = labels.copy()
        labels[valid <= 0] = -1
        # relabel to dense ids in label order, splitting oversized
        # components into runs of max_component_docs rows
        assign = np.full(n, -1, np.int32)
        live = np.nonzero(labels >= 0)[0]
        order = live[np.argsort(labels[live], kind="stable")]
        _, first, counts = np.unique(labels[order], return_index=True,
                                     return_counts=True)
        pieces = -(-counts // max_component_docs)
        base = np.cumsum(pieces) - pieces
        pos = np.arange(len(order)) - np.repeat(first, counts)
        assign[order] = np.repeat(base, counts) + pos // max_component_docs
        next_id = int(pieces.sum())
        centroids, sizes, cohesion = _centroids_of(vectors, assign, next_id)
        return self._finish(vectors, valid, centroids, assign, sizes, epoch,
                            cohesion, t2)

    def build_louvain(
        self, vectors: np.ndarray, valid: np.ndarray, epoch: int = 0,
        min_edge_score: float = 0.25, knn: int = 8, max_passes: int = 8,
    ) -> TopologyArtifacts:
        """Louvain engine: one-level greedy modularity over the device-built
        similarity kNN graph (reference: topology_alternate_engines.cpp)."""
        self.last_timings = {}
        n = len(vectors)
        block = 256
        v, m = self._upload(vectors, valid, (-n) % block)
        t0 = time.perf_counter()
        vals, nbrs = knn_live(v, m, min(knn + 1, max(n, 2)), block)
        vals, nbrs = vals.cpu().numpy()[:n], nbrs.cpu().numpy()[:n]
        t1 = time.perf_counter()
        self.last_timings["knn_s"] = t1 - t0
        # symmetric weighted adjacency (drop self edges + sub-threshold)
        adj: list[dict[int, float]] = [dict() for _ in range(n)]
        for i in range(n):
            if valid[i] <= 0:
                continue
            for w, j in zip(vals[i], nbrs[i]):
                j = int(j)
                if j == i or j >= n or w < min_edge_score or valid[j] <= 0:
                    continue
                wt = float(w)
                adj[i][j] = max(adj[i].get(j, 0.0), wt)
                adj[j][i] = max(adj[j].get(i, 0.0), wt)
        deg = np.array([sum(a.values()) for a in adj])
        two_m = max(deg.sum(), 1e-9)
        comm = np.arange(n)
        comm_deg = deg.copy()
        for _ in range(max_passes):
            moved = False
            for i in range(n):
                if valid[i] <= 0 or not adj[i]:
                    continue
                # weights to neighboring communities
                links: dict[int, float] = {}
                for j, w in adj[i].items():
                    links[comm[j]] = links.get(comm[j], 0.0) + w
                cur = comm[i]
                comm_deg[cur] -= deg[i]
                best, best_gain = cur, links.get(cur, 0.0) - comm_deg[cur] * deg[i] / two_m
                for c, w_in in links.items():
                    gain = w_in - comm_deg[c] * deg[i] / two_m
                    if gain > best_gain + 1e-12:
                        best, best_gain = c, gain
                comm_deg[best] += deg[i]
                if best != cur:
                    comm[i] = best
                    moved = True
            if not moved:
                break
        t2 = time.perf_counter()
        self.last_timings["passes_s"] = t2 - t1
        # package: dense ids in community order, centroids, sizes, cohesion
        assign = np.full(n, -1, np.int32)
        live = valid > 0
        uniq, inv = np.unique(comm[live], return_inverse=True)
        assign[live] = inv
        centroids, sizes, cohesion = _centroids_of(vectors, assign, len(uniq))
        return self._finish(vectors, valid, centroids, assign, sizes, epoch,
                            cohesion, t2)

    def build(self, vectors: np.ndarray, valid: np.ndarray, epoch: int = 0,
              engine: str = "kmeans") -> TopologyArtifacts:
        if engine == "connected":
            return self.build_connected(vectors, valid, epoch)
        if engine == "louvain":
            return self.build_louvain(vectors, valid, epoch)
        self.last_timings = {}
        n_active = int(valid.sum())
        K = auto_k(n_active)
        rng = np.random.default_rng(self.seed + epoch)
        active_rows = np.nonzero(valid > 0)[0]
        if len(active_rows) == 0:
            self._member_csr = None
            self.artifacts = TopologyArtifacts(
                np.zeros((1, vectors.shape[1]), np.float32),
                np.full(len(vectors), -1, np.int32), np.zeros(1), epoch, np.zeros(1),
            )
            return self.artifacts
        init_rows = rng.choice(active_rows, size=K, replace=len(active_rows) < K)
        v, m = self._upload(vectors, valid)
        centroids = torch.from_numpy(
            np.asarray(vectors[init_rows], np.float32)).to(self.device)
        t0 = time.perf_counter()
        for _ in range(self.iters):
            centroids, assign, counts = kmeans_step(v, m, centroids)
        assign, best = kmeans_assign(v, m, centroids)
        assign_np = assign.cpu().numpy()
        best_np = best.cpu().numpy()
        t1 = time.perf_counter()
        self.last_timings["lloyd_s"] = t1 - t0
        cohesion = np.zeros(K, np.float32)
        sizes = np.zeros(K, np.int64)
        order, starts, ends = _members(assign_np, K)
        for c in range(K):
            members = best_np[order[starts[c]:ends[c]]]
            sizes[c] = len(members)
            cohesion[c] = members.mean() if len(members) else 0.0
        return self._finish(vectors, valid, centroids.cpu().numpy(), assign_np,
                            sizes, epoch, cohesion, t1)

    def build_auto(
        self, vectors: np.ndarray, valid: np.ndarray, epoch: int = 0,
        tuner: "TopologyTuner | None" = None,
    ) -> TopologyArtifacts:
        """Tuner-selected engine build: pick an arm, build, feed the reward
        back (reference: TopologyManager arm selection +
        observeRebuildStatsWithPersistence, TopologyManager.cpp:414-429)."""
        if tuner is None:
            return self.build(vectors, valid, epoch)
        arm = tuner.select()
        arts = self.build(vectors, valid, epoch, engine=arm)
        tuner.observe(arm, arts)
        return arts

    def cluster_scores(self, query_vec: np.ndarray,
                       seed_rows: np.ndarray | None = None,
                       alpha: float = 0.5) -> np.ndarray:
        """Blended per-cluster route scores (reference:
        topologySparseDenseAlpha representative scoring,
        topology_routing_session.cpp:167-240).

        dense  = max(sim(q, centroid), max_r sim(q, representative_r)) —
                 the reps catch members of elongated/multi-lobed clusters a
                 centroid matmul under-ranks;
        sparse = normalized seed-document votes (the highest-ranked lexical
                 docs' cluster membership);
        score  = alpha * sparse + (1 - alpha) * dense when seeds exist,
                 else dense.
        """
        a = self.artifacts
        if a is None:
            raise RuntimeError("topology not built")
        q = np.asarray(query_vec, np.float32)
        dense = a.centroids @ q
        if a.rep_vectors is not None and a.rep_vectors.shape[1]:
            K, R, D = a.rep_vectors.shape
            rep_sims = (a.rep_vectors.reshape(K * R, D) @ q).reshape(K, R)
            live = np.arange(R)[None, :] < a.rep_counts[:, None]
            rep_best = np.where(live, rep_sims, -np.inf).max(axis=1)
            dense = np.maximum(dense, np.where(np.isfinite(rep_best),
                                               rep_best, dense))
        if seed_rows is not None and len(seed_rows):
            votes = np.zeros(len(dense), np.float64)
            seeds_c = a.assignments[seed_rows]
            seeds_c = seeds_c[seeds_c >= 0]
            if len(seeds_c):
                np.add.at(votes, seeds_c, 1.0)
                votes /= votes.max()
                return (alpha * votes + (1.0 - alpha) * dense).astype(
                    np.float32)
        return dense.astype(np.float32)

    def select_routes(
        self, query_vec: np.ndarray, seed_rows: np.ndarray | None = None,
        *, min_clusters: int = 1, max_clusters: int = 4,
        adaptive_score_gap: float = 0.0, alpha: float = 0.5,
        min_boundary_margin: float = 0.0, budget_rows: int = 0,
    ) -> RouteSelection:
        """Route one query -> cluster selection + certificate metadata.

        Adaptive probing (reference topologyAdaptiveProbeScoreGap): with a
        positive gap, widen from min_clusters while a cluster's score stays
        within `gap` of the best; gap 0 keeps fixed max_clusters. Abstention
        (topologyNarrowMinBoundaryMargin): when the selected/excluded score
        boundary is closer than the margin, the route is NOT a trustworthy
        narrowing certificate — callers fall back to the full scan. Work
        budget (TopologyRouteWorkBudget.maxRowsVisited): drop lowest-scoring
        selected clusters while the routed member-row total exceeds
        budget_rows (never below min_clusters)."""
        a = self.artifacts
        scores = self.cluster_scores(query_vec, seed_rows, alpha)
        K = len(scores)
        order = np.argsort(-scores, kind="stable")
        lo = max(1, min(min_clusters, K))
        hi = max(lo, min(max_clusters, K))
        if adaptive_score_gap > 0.0:
            sel = lo
            best = scores[order[0]]
            while sel < hi and best - scores[order[sel]] <= adaptive_score_gap:
                sel += 1
        else:
            sel = hi
        clusters = order[:sel]
        budget_clamped = False
        if budget_rows > 0:
            while (len(clusters) > lo
                   and a.cluster_sizes[clusters].sum() > budget_rows):
                clusters = clusters[:-1]
                budget_clamped = True
        rows_routed = int(a.cluster_sizes[clusters].sum())
        sel = len(clusters)
        margin = (float(scores[order[sel - 1]] - scores[order[sel]])
                  if sel < K else float("inf"))
        abstained = (min_boundary_margin > 0.0 and sel < K
                     and margin < min_boundary_margin)
        return RouteSelection(
            clusters=clusters, scores=scores[clusters],
            boundary_margin=margin, abstained=abstained,
            rows_routed=rows_routed, budget_clamped=budget_clamped,
        )

    def route(self, query_vec: np.ndarray, top_clusters: int = 4) -> np.ndarray:
        """Query -> routed cluster ids (representative-aware top-C)."""
        return self.select_routes(
            query_vec, max_clusters=top_clusters).clusters

    def member_rows(self, clusters: np.ndarray) -> np.ndarray:
        """Row indices of the given clusters' members, O(rows routed).

        Feeds the Narrow gather-scan fast path (ops.scan.routed_gather_topk):
        unlike routed_row_mask this never touches non-routed rows. The
        per-cluster CSR view (argsort by assignment) builds once per
        topology and is invalidated with the artifacts."""
        if getattr(self, "_member_csr", None) is None:
            a = self.artifacts
            order = np.argsort(a.assignments, kind="stable").astype(np.int32)
            sorted_assign = a.assignments[order]
            k = len(a.cluster_sizes)
            starts = np.searchsorted(sorted_assign, np.arange(k))
            ends = np.searchsorted(sorted_assign, np.arange(k), side="right")
            self._member_csr = (order, starts, ends)
        order, starts, ends = self._member_csr
        if len(clusters) == 0:
            return np.empty(0, np.int32)
        return np.concatenate(
            [order[starts[c]:ends[c]] for c in clusters])

    def routed_row_mask(self, query_vec: np.ndarray, top_clusters: int = 4,
                        policy: str = "augment",
                        selection: RouteSelection | None = None) -> np.ndarray:
        """Row mask for the scan, per routing policy.

        narrow:  scan only routed clusters' members.
        augment: scan everything (mask of ones) but callers may boost routed.
        shadow:  counterfactual — returns the narrow mask for comparison while
                 production scans everything (reference default,
                 search_engine_config.h:140-166).
        """
        a = self.artifacts
        if selection is None:
            selection = self.select_routes(
                query_vec, max_clusters=top_clusters)
        mask = np.isin(a.assignments, selection.clusters).astype(np.float32)
        if policy == "augment":
            return np.ones_like(mask)
        return mask


class TopologyTuner:
    """UCB1 bandit over topology engines, rewarded by rebuild quality.

    The reference's TopologyTuner observes each rebuild's stats plus the
    centroid H_0 persistence and supports geometric / persistence / hybrid
    reward modes (TopologyManager.cpp:414-429). Rewards here:

      geometric   — mean member-to-centroid cohesion (compactness)
      persistence — centroid persistence normalized by cluster count
                    (spread-out, non-collapsed centroid structure)
      hybrid      — mean of both (the reference default)
    """

    ARMS = ("kmeans", "connected", "louvain")

    def __init__(self, reward_mode: str = "hybrid", exploration: float = 0.5):
        assert reward_mode in ("geometric", "persistence", "hybrid")
        self.reward_mode = reward_mode
        self.exploration = exploration
        self.counts = {a: 0 for a in self.ARMS}
        self.totals = {a: 0.0 for a in self.ARMS}
        self.history: list[tuple[str, float]] = []

    def select(self) -> str:
        for a in self.ARMS:          # play every arm once first
            if self.counts[a] == 0:
                return a
        n = sum(self.counts.values())
        def ucb(a):
            mean = self.totals[a] / self.counts[a]
            return mean + self.exploration * np.sqrt(
                2.0 * np.log(n) / self.counts[a])
        return max(self.ARMS, key=ucb)

    def reward_of(self, arts: TopologyArtifacts) -> float:
        live = arts.cluster_sizes > 0
        geometric = float(arts.cohesion[live].mean()) if live.any() else 0.0
        k = max(int(live.sum()), 1)
        persistence = min(arts.centroid_persistence / max(k - 1, 1), 1.0)
        if self.reward_mode == "geometric":
            return geometric
        if self.reward_mode == "persistence":
            return persistence
        return 0.5 * (geometric + persistence)

    def observe(self, arm: str, arts: TopologyArtifacts) -> float:
        r = self.reward_of(arts)
        self.counts[arm] += 1
        self.totals[arm] += r
        self.history.append((arm, r))
        return r

    def snapshot(self) -> dict:
        return {
            "reward_mode": self.reward_mode,
            "arms": {
                a: {"plays": self.counts[a],
                    "mean_reward": (self.totals[a] / self.counts[a]
                                    if self.counts[a] else None)}
                for a in self.ARMS
            },
        }
