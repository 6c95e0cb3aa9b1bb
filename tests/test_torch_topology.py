"""The port's topology layer against yams_tpu/index/topology.py, on the CPU.

The same seeded NumPy inputs go through the JAX function and its torch
counterpart:

- `segment_sum` (sorted segments, no float atomics) equals
  jax.ops.segment_sum within 1e-5;
- `kmeans_assign` / `kmeans_step`: assignments equal except rows whose
  top-2 centroid margin is under 1e-3 (named), `best` and the new centroids
  within 1e-5, counts equal, an empty cluster keeps its centroid, invalid
  rows are (-1, 0.0);
- `connected_labels`: equal labels on a fixture whose edge scores keep a
  margin around the 0.25 threshold, with padded (invalid) rows;
- the three `TopologyEngine` builds on a separated 3,072-row fixture: equal
  artifacts (assignments and sizes equal; centroids, cohesion,
  representatives and persistence within 1e-5), also with the kNN
  self-join cut into query slices of 256 rows (its lists: values within
  1e-5, equal ids), and a topology tuner over the engine picks the same
  arms with the same rewards;
- `routed_gather_topk`: values within 1e-5, equal ids, padding at -1e30,
  and a tie fixture in lax.top_k's order (ties to the lower position);
- `convert.topology_from_jax` / `load_topology` carry a reference topology
  into the port: equal artifacts, member rows and routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yams_tpu.index import topology as ref_topo
from yams_tpu.ops.scan import exact_topk_scan as ref_exact_topk_scan
from yams_tpu.ops.scan import routed_gather_topk as ref_gather
from yams_tpu_torch.convert import topology_from_jax, topology_tuner_from_jax
from yams_tpu_torch.index import topology as topo
from yams_tpu_torch.ops.scan import routed_gather_topk

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _clustered(n, d, k, sigma, seed):
    rng = np.random.default_rng(seed)
    cent = _unit(rng.standard_normal((k, d)))
    lab = rng.integers(0, k, n)
    return _unit(cent[lab] + sigma * rng.standard_normal((n, d))), lab


def _margin(v, c):
    """Each row's gap between its best and second-best centroid score."""
    s = v.astype(np.float64) @ c.astype(np.float64).T
    top2 = np.sort(s, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_segment_sum_matches_jax():
    """On kmeans_step's input: unit rows and a column of ones (the counts)."""
    rng = np.random.default_rng(0)
    data = np.hstack([_unit(rng.standard_normal((2000, 24))), np.ones((2000, 1), np.float32)])
    seg = rng.integers(0, 42, 2000)         # segment 41 lies outside: dropped
    seg[seg == 7] = 8                        # an empty segment sums to 0
    seg[:300] = 3                            # a segment of many pieces
    got = topo.segment_sum(_t(data), _t(seg), 41).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg),
                                          num_segments=41))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got.shape == (41, 25) and not got[7].any()
    assert np.array_equal(got[:, -1], np.bincount(seg, minlength=42)[:41])


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_step_matches_jax(seed):
    v, _ = _clustered(1500, 48, 12, 0.3, seed)
    valid = np.ones(len(v), np.float32)
    valid[::13] = 0
    rng = np.random.default_rng(seed + 10)
    c0 = v[rng.choice(len(v), 16, replace=False)].copy()
    c0[15] = c0[14]          # an exact tie: the first maximum wins, 15 stays empty
    ga, gb = topo.kmeans_assign(_t(v), _t(valid), _t(c0))
    wa, wb = ref_topo.kmeans_assign(jnp.asarray(v), jnp.asarray(valid), jnp.asarray(c0))
    ga, gb, wa, wb = ga.numpy(), gb.numpy(), np.asarray(wa), np.asarray(wb)
    differ = np.nonzero(ga != wa)[0]
    assert (_margin(v[differ], c0) < 1e-3).all(), \
        f"rows {differ.tolist()} differ with a margin >= 1e-3"
    np.testing.assert_allclose(gb, wb, atol=1e-5, rtol=0)
    assert (ga[valid == 0] == -1).all() and (gb[valid == 0] == 0).all()
    new, assign, counts = topo.kmeans_step(_t(v), _t(valid), _t(c0))
    w_new, w_assign, w_counts = ref_topo.kmeans_step(
        jnp.asarray(v), jnp.asarray(valid), jnp.asarray(c0))
    assert np.array_equal(counts.numpy(), np.asarray(w_counts))
    assert counts[15] == 0
    np.testing.assert_allclose(new.numpy(), np.asarray(w_new), atol=1e-5, rtol=0)
    # the empty cluster keeps its (renormalized) centroid
    np.testing.assert_allclose(new[15].numpy(), c0[15], atol=1e-6)


def _threshold_fixture(n=700, d=32, seed=3):
    """Pairs of rows whose similarity sits clear of 0.25 on either side."""
    rng = np.random.default_rng(seed)
    base = _unit(rng.standard_normal((n // 2, d)))
    out = []
    for i, b in enumerate(base):
        target = 0.6 if i % 3 else 0.05               # above / below the threshold
        noise = _unit(rng.standard_normal((1, d)))[0]
        noise = _unit((noise - (noise @ b) * b)[None])[0]
        out += [b, target * b + np.sqrt(1 - target ** 2) * noise]
    v = np.asarray(out, np.float32)
    return v


def test_connected_labels_match_jax():
    v = _threshold_fixture()
    n = len(v)
    pad = (-n) % 256
    vp = np.pad(v, ((0, pad), (0, 0)))
    valid = np.pad(np.ones(n, np.float32), (0, pad))
    valid[5] = 0
    got = topo.connected_labels(_t(vp), _t(valid), 0.25, knn=4, block_rows=256).numpy()
    want = np.asarray(ref_topo.connected_labels(
        jnp.asarray(vp), jnp.asarray(valid), 0.25, knn=4, block_rows=256))
    assert np.array_equal(got, want)
    assert (got[n:] == np.arange(n, n + pad)).all()     # padded rows label themselves
    assert len(np.unique(got[:n])) < n                  # edges above 0.25 joined rows


@pytest.fixture(scope="module")
def separated():
    v, _ = _clustered(3072, 64, 24, 0.12, seed=7)
    valid = np.ones(len(v), np.float32)
    valid[::97] = 0
    return v, valid


def _same_artifacts(got, want):
    assert np.array_equal(got.assignments, want.assignments)
    assert np.array_equal(got.cluster_sizes, want.cluster_sizes)
    assert got.epoch == want.epoch
    for name in ("centroids", "cohesion", "rep_vectors", "rep_counts"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert got.centroid_persistence == pytest.approx(want.centroid_persistence, abs=1e-5)


@pytest.mark.parametrize("engine", ["kmeans", "connected", "louvain"])
def test_builds_match_jax(separated, engine):
    v, valid = separated
    got = topo.TopologyEngine(device=CPU).build(v, valid, epoch=3, engine=engine)
    want = ref_topo.TopologyEngine().build(v, valid, epoch=3, engine=engine)
    _same_artifacts(got, want)
    assert len(got.centroids) > 1


@pytest.mark.parametrize("engine", ["connected", "louvain"])
def test_sliced_self_join_matches_jax(separated, engine, monkeypatch):
    """The kNN self-join in query slices of 256 rows (12 slices of the
    3,040 live rows, the last of 224, the 32 dead rows scattered through
    them): the live rows get the reference's lists (values within 1e-5,
    equal ids), and connected_labels and the build the reference's."""
    v, valid = separated
    monkeypatch.setattr(topo, "_KNN_QUERIES", 256)
    knn = 9 if engine == "louvain" else 8
    vals, nbrs = topo.knn_live(_t(v), _t(valid), knn, 256)
    w_vals, w_nbrs = (np.asarray(x) for x in ref_exact_topk_scan(
        jnp.asarray(v), jnp.asarray(v), jnp.asarray(valid), k=knn, block_rows=256))
    live = valid > 0
    np.testing.assert_allclose(vals.numpy()[live], w_vals[live], atol=1e-5, rtol=0)
    assert np.array_equal(nbrs.numpy()[live], w_nbrs[live])
    assert (nbrs.numpy()[~live] == -1).all()
    got = topo.connected_labels(_t(v), _t(valid), 0.25, knn=8, block_rows=256).numpy()
    want = np.asarray(ref_topo.connected_labels(
        jnp.asarray(v), jnp.asarray(valid), 0.25, knn=8, block_rows=256))
    assert np.array_equal(got, want)
    built = topo.TopologyEngine(device=CPU).build(v, valid, epoch=3, engine=engine)
    _same_artifacts(built, ref_topo.TopologyEngine().build(v, valid, epoch=3, engine=engine))


def test_topology_tuner_matches_jax(separated):
    v, valid = separated
    port_eng, ref_eng = topo.TopologyEngine(device=CPU), ref_topo.TopologyEngine()
    port_tuner, ref_tuner = topo.TopologyTuner(), ref_topo.TopologyTuner()
    for epoch in range(5):
        got = port_eng.build_auto(v, valid, epoch, tuner=port_tuner)
        want = ref_eng.build_auto(v, valid, epoch, tuner=ref_tuner)
        assert np.array_equal(got.assignments, want.assignments)
    assert [a for a, _ in port_tuner.history] == [a for a, _ in ref_tuner.history]
    np.testing.assert_allclose([r for _, r in port_tuner.history],
                               [r for _, r in ref_tuner.history], atol=1e-6)
    assert port_tuner.counts == ref_tuner.counts
    carried = topology_tuner_from_jax(ref_tuner)
    assert carried.select() == ref_tuner.select() and carried.history == ref_tuner.history


@pytest.mark.parametrize("k", [1, 10, 64])
def test_routed_gather_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    corpus = _unit(rng.standard_normal((900, 40)))
    q = _unit(rng.standard_normal((5, 40)))
    R = 128
    row_idx = rng.integers(0, 900, (5, R)).astype(np.int32)
    row_ok = np.ones((5, R), np.float32)
    row_ok[1, 60:] = 0
    row_idx[1, 60:] = 0
    row_ok[3, 5:] = 0
    row_idx[3, 5:] = 0
    corpus16 = torch.from_numpy(corpus).to(torch.bfloat16)
    gv, gi = routed_gather_topk(_t(q), corpus16, _t(row_idx), _t(row_ok), k)
    wv, wi = ref_gather(jnp.asarray(q), jnp.asarray(corpus, jnp.bfloat16),
                        jnp.asarray(row_idx), jnp.asarray(row_ok), k)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5, rtol=0)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    if k == 64:
        assert (gv[3, 5:] == -1e30).all()


def test_routed_gather_topk_tie_order():
    """Duplicate rows score equal: lax.top_k keeps the lower position first,
    and so must the port (torch.topk leaves that order open)."""
    rng = np.random.default_rng(4)
    corpus = _unit(rng.standard_normal((16, 8)))
    corpus[[3, 7, 9, 12]] = corpus[5]
    q = corpus[5:6].copy()
    row_idx = np.array([[12, 3, 0, 9, 5, 7, 1, 2]], np.int32)
    row_ok = np.ones((1, 8), np.float32)
    gv, gi = routed_gather_topk(_t(q), torch.from_numpy(corpus).to(torch.bfloat16),
                                _t(row_idx), _t(row_ok), 6)
    wv, wi = ref_gather(jnp.asarray(q), jnp.asarray(corpus, jnp.bfloat16),
                        jnp.asarray(row_idx), jnp.asarray(row_ok), 6)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert gi[0, :5].tolist() == [12, 3, 9, 5, 7]


def test_topology_from_jax_round_trip(separated):
    v, valid = separated
    ref = ref_topo.TopologyEngine()
    ref.build(v, valid, epoch=2)
    port = topology_from_jax(ref, device=CPU)
    _same_artifacts(port.artifacts, ref.artifacts)
    clusters = np.array([3, 0, 7])
    assert np.array_equal(port.member_rows(clusters), ref.member_rows(clusters))
    rng = np.random.default_rng(1)
    for qv in _unit(rng.standard_normal((8, 64))):
        want = ref.select_routes(qv, max_clusters=4, min_boundary_margin=0.05)
        got = port.select_routes(qv, max_clusters=4, min_boundary_margin=0.05)
        assert np.array_equal(got.clusters, want.clusters)
        assert (got.abstained, got.rows_routed) == (want.abstained, want.rows_routed)
        assert np.array_equal(port.routed_row_mask(qv, policy="narrow"),
                              ref.routed_row_mask(qv, policy="narrow"))
    back = topology_from_jax(port, device=CPU)        # port -> port
    _same_artifacts(back.artifacts, port.artifacts)
