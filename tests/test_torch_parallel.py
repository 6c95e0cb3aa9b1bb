"""Port parity: the mesh helpers and the sharded scans (yams_tpu_torch.parallel).

Seeded NumPy corpora go through yams_tpu's sharded programs on its
8-device virtual CPU mesh and through the port's on a virtual mesh of 8
CPU shards: sharded_topk, sharded_int8_topk and sharded_pq_topk (packed4,
group 1 and 8) give the same global rows and values within 1e-5 (f32 sums
of bf16 products, or of the bf16 ADC table, in another order; the int8
products are exact), sharded_hybrid_scores the same slots and values within
1e-5. The reference's own checks (tests/test_parallel.py) are rerun on the
port's results.
"""

import jax
import jax.numpy as jnp
import jax.sharding as jsh
import numpy as np
import pytest
import torch

from yams_tpu.ops.pq import pq4_pack, pq_encode, pq_train
from yams_tpu.ops.scan import quantize_int8
from yams_tpu.parallel import corpus_mesh as ref_corpus_mesh
from yams_tpu.parallel import sharded_scan as ref
from yams_tpu_torch.ops.pq import pq_adc_topk
from yams_tpu_torch.ops.scan import exact_topk_scan
from yams_tpu_torch.parallel import corpus_mesh, pad_to_shards
from yams_tpu_torch.parallel import mesh as pm
from yams_tpu_torch.parallel import sharded_scan as port

CPU = torch.device("cpu")


def _jit(fn, *static):
    """The reference under jit: called eagerly its shard_map dispatches op
    by op, many times slower on the virtual mesh."""
    return jax.jit(fn, static_argnums=(0,), static_argnames=static)


def _unit(n, d, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8
    return ref_corpus_mesh(8), pm.virtual_mesh(8, "d", CPU)


def _put(mesh, x):
    spec = jsh.PartitionSpec("d", None) if x.ndim == 2 else jsh.PartitionSpec("d")
    return jax.device_put(jnp.asarray(x), jsh.NamedSharding(mesh, spec))


def _same(want, got, atol=1e-5):
    wv, wi = (np.asarray(a) for a in want)
    gv, gi = (a.numpy() for a in got)
    assert np.array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, atol=atol, rtol=0)


# -- mesh helpers -------------------------------------------------------------------
def test_pad_to_shards():
    assert pad_to_shards(1000, 8, 128) == 1024
    assert pad_to_shards(1, 8, 128) == 1024
    assert pad_to_shards(2048, 8, 128) == 2048


def test_mesh_shape_order_and_collectives():
    m = pm.virtual_mesh((2, 4), ("dcn", "ici"), CPU)
    assert m.shape == {"dcn": 2, "ici": 4} and m.size == 8 and m.lead == CPU
    assert len(list(m.devices.flat)) == 8
    assert pm.shard_grid(m, ("dcn", "ici")).shape == (2, 4)
    # a subset of the axes: the other axis holds replicas
    assert len(pm.shard_devices(m, "ici")) == 4
    with pytest.raises(ValueError, match="not in the mesh"):
        pm.shard_devices(m, "d")
    x = torch.arange(16.0).reshape(8, 2)
    parts = pm.shard_rows(m, x, ("dcn", "ici"))
    assert [p.tolist() for p in parts] == [x[i:i + 1].tolist() for i in range(8)]
    with pytest.raises(ValueError, match="do not split"):
        pm.shard_rows(m, torch.zeros(6, 2), ("dcn", "ici"))
    a, b = torch.tensor([[1.0, 5.0]]), torch.tensor([[3.0, 2.0]])
    assert pm.all_gather([a, b]).tolist() == [[1.0, 5.0, 3.0, 2.0]]
    assert pm.pmax([a, b]).tolist() == [[3.0, 5.0]]
    assert pm.psum([a, b]).tolist() == [[4.0, 7.0]]
    with pytest.raises(ValueError, match="repeated"):
        pm.Mesh(np.array([[CPU]], dtype=object), ("d", "d"))


def test_corpus_mesh_counts_visible_devices(monkeypatch):
    assert corpus_mesh(device="cpu").shape == {"d": 1}
    with pytest.raises(ValueError, match="only 1 available"):
        corpus_mesh(2, device="cpu")
    monkeypatch.setattr(pm, "visible_devices", lambda device: [CPU] * 8)
    assert corpus_mesh(device="cpu").shape == {"d": 8}
    assert corpus_mesh(4, axis="x", device="cpu").shape == {"x": 4}


# -- sharded scans ------------------------------------------------------------------
def test_sharded_topk_matches_reference(meshes):
    rm, m = meshes
    N, D, B, k = 8 * 256, 64, 4, 10
    e, q = _unit(N, D), _unit(B, D, seed=1)
    e[700] = e[300]                      # an exact tie across shards
    valid = np.ones(N, np.float32)
    valid[100:300] = 0.0
    want = _jit(ref.sharded_topk, "k", "block_rows", "axis")(
        rm, jnp.asarray(q), *ref.shard_corpus(rm, jnp.asarray(e), jnp.asarray(valid)),
        k=k, block_rows=128)
    ec, vc = port.shard_corpus(m, torch.from_numpy(e).bfloat16(), torch.from_numpy(valid))
    got = port.sharded_topk(m, torch.from_numpy(q), ec, vc, k=k, block_rows=128)
    _same(want, got)
    # the reference test's oracle check, and the port's own single-device scan
    idx = got[1].numpy()
    assert np.all((idx >= 0) & (idx < N)) and not np.isin(idx, np.arange(100, 300)).any()
    sv, si = exact_topk_scan(torch.from_numpy(q), torch.from_numpy(e).bfloat16(),
                             torch.from_numpy(valid), k, block_rows=128)
    assert np.array_equal(si.numpy(), idx)


def test_sharded_topk_fewer_live_rows_than_k(meshes):
    """Shards with no live row give (-1e30, -1); -1 stays -1 in the merge."""
    rm, m = meshes
    N, D = 8 * 16, 32
    e, q = _unit(N, D, seed=3), _unit(2, D, seed=4)
    valid = np.zeros(N, np.float32)
    valid[[5, 40]] = 1.0
    want = _jit(ref.sharded_topk, "k", "block_rows", "axis")(
        rm, jnp.asarray(q), _put(rm, e), _put(rm, valid), k=4, block_rows=16)
    got = port.sharded_topk(m, torch.from_numpy(q), torch.from_numpy(e).bfloat16(),
                            torch.from_numpy(valid), k=4, block_rows=16)
    _same(want, got)
    assert (got[1][:, 2:] == -1).all()


def test_sharded_int8_topk_matches_reference(meshes):
    rm, m = meshes
    N, D, B, k = 8 * 256, 128, 4, 10
    e, q = _unit(N, D, seed=9), _unit(B, D, seed=10)
    q8, scale = quantize_int8(e)
    valid = np.ones(N, np.float32)
    want = _jit(ref.sharded_int8_topk, "k", "block_rows", "axis")(
        rm, jnp.asarray(q), _put(rm, q8), _put(rm, scale), _put(rm, valid), k=k,
        block_rows=128)
    got = port.sharded_int8_topk(m, torch.from_numpy(q), torch.from_numpy(q8),
                                 torch.from_numpy(scale), torch.from_numpy(valid), k=k,
                                 block_rows=128)
    _same(want, got)
    oi = np.argsort(-(q @ e.T), axis=1)[:, :k]
    recall = np.mean([len(set(got[1].numpy()[i]) & set(oi[i])) / k for i in range(B)])
    assert recall > 0.8


@pytest.fixture(scope="module")
def pq_problem():
    N, D, B = 8 * 256, 64, 4
    e, q = _unit(N, D, seed=20), _unit(B, D, seed=21)
    cb = pq_train(e, m=16, ksub=16, iters=6)
    packed = pq4_pack(np.asarray(pq_encode(cb, e)))
    valid = np.ones(N, np.float32)
    valid[50:80] = 0.0
    return q, packed, np.array(cb.centroids), valid


@pytest.mark.parametrize("group", [1, 8])
def test_sharded_pq_topk_matches_reference(meshes, pq_problem, group):
    rm, m = meshes
    q, packed, cent, valid = pq_problem
    want = _jit(ref.sharded_pq_topk, "k", "block_rows", "packed4", "group", "axis")(
        rm, jnp.asarray(q), _put(rm, packed), jnp.asarray(cent), _put(rm, valid), k=10,
        block_rows=128, packed4=True, group=group)
    args = (torch.from_numpy(q), torch.from_numpy(packed), torch.from_numpy(cent),
            torch.from_numpy(valid))
    got = port.sharded_pq_topk(m, *args, k=10, block_rows=128, packed4=True, group=group)
    _same(want, got)
    # the reference test's checks: the single-device ADC set, no dead row,
    # and a grouped scan's top-1 is the exact scan's
    ov, oi = pq_adc_topk(*args, k=10, block_rows=256, packed4=True)
    if group == 1:
        for i in range(len(q)):
            assert set(got[1][i].tolist()) == set(oi[i].tolist())
    else:
        assert np.array_equal(got[1][:, 0].numpy(), oi[:, 0].numpy())
    assert not set(got[1][0].tolist()) & set(range(50, 80))


def test_sharded_pq_windows_never_straddle_a_shard(meshes, pq_problem):
    _, m = meshes
    q, packed, cent, valid = pq_problem
    with pytest.raises(ValueError, match="windows of 512"):
        port.sharded_pq_topk(m, torch.from_numpy(q), torch.from_numpy(packed),
                             torch.from_numpy(cent), torch.from_numpy(valid), k=10,
                             block_rows=512, packed4=True, group=512)


def test_sharded_hybrid_scores_matches_reference(meshes):
    rm, m = meshes
    N, D, B, Nd, k = 8 * 128, 32, 2, 128, 5
    e = _unit(N, D)
    q = e[::N // B][:B].copy()
    valid = np.ones(N, np.float32)
    valid[3::17] = 0.0
    row2slot = (np.arange(N) % Nd).astype(np.int32)
    row2slot[valid == 0] = -1
    bm = np.zeros((B, Nd), np.float32)
    bm[0, 7] = 30.0
    bm[1, 9] = 12.0
    want = _jit(ref.sharded_hybrid_scores, "num_slots", "k", "axis", "text_weight",
                "vector_weight")(
        rm, jnp.asarray(q), _put(rm, e), _put(rm, valid), _put(rm, row2slot),
        jnp.asarray(bm), num_slots=Nd, k=k)
    got = port.sharded_hybrid_scores(
        m, torch.from_numpy(q), torch.from_numpy(e).bfloat16(), torch.from_numpy(valid),
        torch.from_numpy(row2slot), torch.from_numpy(bm), num_slots=Nd, k=k)
    _same(want, got)
    assert got[1][0, 0] == 7       # the reference test's strong lexical hit


@pytest.mark.parametrize("n_shards", [2, 4])
def test_merge_matches_any_shard_count(n_shards):
    """The merge is the single-device scan whatever the shard count."""
    N, D = 8 * 64, 32
    e, q = torch.from_numpy(_unit(N, D, seed=7)).bfloat16(), torch.from_numpy(_unit(3, D, 8))
    valid = torch.ones(N)
    want = exact_topk_scan(q, e, valid, 7, block_rows=64)
    got = port.sharded_topk(pm.virtual_mesh(n_shards, "d", CPU), q, e, valid, 7,
                            block_rows=64)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_parts_placed_where_the_mesh_says():
    """A list of parts on another device is moved; a wrong count raises."""
    m = pm.virtual_mesh(2, "d", CPU)
    parts = [torch.zeros(4, 2), torch.ones(4, 2)]
    assert all(p.device == CPU for p in pm.shard_rows(m, parts))
    with pytest.raises(ValueError, match="3 parts for 2 shards"):
        pm.shard_rows(m, parts + parts[:1])
