"""Port parity: product quantization (ops/pq.py) and the PQ4 kernel K4
(ops/pq_pallas.py).

Seeded NumPy vectors go through yams_tpu's functions (XLA on the CPU; the
Pallas ADC kernel in interpret mode, as tests/test_pq.py runs it) and the
port's, whose K4 step on a CPU tensor is the plain twin `pq4_adc_reference`.

- Lloyd steps from the reference's own initial centroids (drawn with
  jax.random.choice, which the port cannot reproduce) equal JAX's to 1e-5;
  end to end from the port's own draw, the quantization MSE is within 2%.
- Codes, packing, ADC scores and window maxima: both sides sum the bf16 LUT
  entries of each code in f32, so values agree to 1e-5 and rows are equal
  wherever no near-tie (< 1e-5) decides them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yams_tpu.ops import pq as ref_pq
from yams_tpu.ops import pq_pallas as ref_pallas
from yams_tpu_torch.ops import pq as port_pq
from yams_tpu_torch.ops import pq_pallas as port_pallas

CPU = torch.device("cpu")
N, D, M, B = 2048, 64, 16, 4


def _unit(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    vecs = _unit(N, D, seed=3)
    cb = ref_pq.pq_train(vecs, m=M, ksub=16, train_limit=1024, iters=5)
    codes = np.asarray(ref_pq.pq_encode(cb, vecs))
    valid = np.ones(N, np.float32)
    valid[100:300] = 0.0
    valid[np.random.default_rng(4).random(N) < 0.05] = 0.0
    return dict(vecs=vecs, cent=np.asarray(cb.centroids), codes=codes,
                packed=ref_pq.pq4_pack(codes), valid=valid, q=_unit(B, D, seed=5))


def _t(x):
    return torch.from_numpy(np.array(x))   # a writable copy


def _reconstruction_mse(cent, codes, vecs):
    m = cent.shape[0]
    rec = np.concatenate([cent[s][codes[:, s]] for s in range(m)], axis=1)
    return float(((rec - vecs) ** 2).sum(axis=1).mean())


@pytest.mark.parametrize("m,ksub,iters", [(16, 16, 5), (8, 64, 3)])
def test_lloyd_steps_match_reference_from_its_init(m, ksub, iters):
    sample = _unit(512, D, seed=6)
    seed = 0
    sub = jnp.transpose(jnp.asarray(sample).reshape(512, m, D // m), (1, 0, 2))
    init = jax.random.choice(jax.random.PRNGKey(seed), 512, (m, ksub), replace=True)
    cent0 = np.asarray(jax.vmap(lambda s, i: s[i])(sub, init))
    want = ref_pq._train_jit(jnp.asarray(sample), seed, m=m, ksub=ksub, iters=iters)
    got = port_pq._lloyd(port_pq._split(_t(sample), m), _t(cent0), iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("m,ksub", [(16, 16), (8, 256)])
def test_pq_train_quantization_mse_within_2pct(m, ksub):
    vecs = _unit(N, D, seed=7)
    ref = ref_pq.pq_train(vecs, m=m, ksub=ksub, train_limit=1024)
    port = port_pq.pq_train(vecs, m=m, ksub=ksub, train_limit=1024, device=CPU)
    assert port.centroids.shape == tuple(np.asarray(ref.centroids).shape)
    want = _reconstruction_mse(np.asarray(ref.centroids),
                               np.asarray(ref_pq.pq_encode(ref, vecs)), vecs)
    got = _reconstruction_mse(port.centroids.numpy(),
                              port_pq.pq_encode(port, vecs).numpy(), vecs)
    assert abs(got - want) <= 0.02 * want, (got, want)


def test_pq_train_is_seeded():
    vecs = _unit(N, D, seed=8)
    a = port_pq.pq_train(vecs, m=M, ksub=16, train_limit=1024, device=CPU)
    b = port_pq.pq_train(vecs, m=M, ksub=16, train_limit=1024, device=CPU)
    assert torch.equal(a.centroids, b.centroids)


def test_pq_encode_matches_reference(data):
    cb = port_pq.PQCodebook(_t(data["cent"]), M, 16, D // M)
    got = port_pq.pq_encode(cb, data["vecs"]).numpy()
    want = data["codes"]
    assert got.dtype == np.uint8 and got.shape == want.shape
    flips = np.argwhere(got != want)
    assert len(flips) <= 0.001 * want.size
    for r, s in flips:   # a flip may only happen on a near-tie
        sub = data["vecs"][r, s * (D // M):(s + 1) * (D // M)]
        c = data["cent"][s]
        score = c @ sub - 0.5 * (c * c).sum(axis=1)
        assert abs(score[got[r, s]] - score[want[r, s]]) < 1e-5


def test_pq4_pack_bit_equal_and_unpacks(data):
    got = port_pq.pq4_pack(_t(data["codes"]))
    assert np.array_equal(got, data["packed"])
    assert np.array_equal(port_pq.pq4_unpack(_t(got)).numpy(), data["codes"])
    with pytest.raises(ValueError):
        port_pq.pq4_pack(np.full((2, 4), 16, np.uint8))


def _assert_windows_equal(got_v, got_i, want_v, want_i, tol=1e-5):
    """Values to tol; ids wherever the value is live and not a near-tie with
    its neighbour in rank order."""
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, atol=tol, rtol=0)
    gap = np.full(want_v.shape, np.inf, np.float32)
    gap[:, 1:] = np.minimum(gap[:, 1:], np.abs(np.diff(want_v, axis=1)))
    gap[:, :-1] = np.minimum(gap[:, :-1], np.abs(np.diff(want_v, axis=1)))
    sure = (want_v > -1e29) & (gap > tol)
    np.testing.assert_array_equal(got_i[sure], want_i[sure])


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("packed4", [False, True])
def test_pq_adc_topk_matches_reference(data, packed4, group, filtered):
    codes = data["packed"] if packed4 else data["codes"]
    slots = doc_mask = None
    if filtered:
        rng = np.random.default_rng(9)
        slots = rng.integers(-1, 300, N).astype(np.int32)
        doc_mask = (rng.random((B, 300)) < 0.3).astype(np.float32)
    k = 40
    want = ref_pq.pq_adc_topk(
        jnp.asarray(data["q"]), jnp.asarray(codes), jnp.asarray(data["cent"]),
        jnp.asarray(data["valid"]), k=k, block_rows=512, packed4=packed4, group=group,
        slots=None if slots is None else jnp.asarray(slots),
        doc_mask=None if doc_mask is None else jnp.asarray(doc_mask))
    got = port_pq.pq_adc_topk(
        _t(data["q"]), _t(codes), _t(data["cent"]), _t(data["valid"]), k,
        block_rows=512, packed4=packed4, group=group,
        slots=None if slots is None else _t(slots),
        doc_mask=None if doc_mask is None else _t(doc_mask))
    _assert_windows_equal(*got, *want)
    if filtered:   # every live candidate passes the pushed-down filter
        v, rows = got[0].numpy(), got[1].numpy()
        for b in range(B):
            live = rows[b][v[b] > -1e29]
            assert np.all(doc_mask[b][slots[live]] == 1) and np.all(slots[live] >= 0)


def test_exact_rerank_matches_reference(data):
    rng = np.random.default_rng(10)
    cand = rng.integers(-1, N, (B, 24)).astype(np.int32)
    cvals = rng.standard_normal((B, 24)).astype(np.float32)
    cvals[:, ::5] = -1e30
    E = data["vecs"]
    want = ref_pq.exact_rerank(jnp.asarray(data["q"]), jnp.asarray(E, jnp.bfloat16),
                               jnp.asarray(cand), jnp.asarray(cvals), -1e29, k=10)
    got = port_pq.exact_rerank(_t(data["q"]), _t(E).bfloat16(), _t(cand), _t(cvals),
                               -1e29, k=10)
    _assert_windows_equal(*got, *want)


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("group", [4, 8, 16])
def test_k4_twin_matches_pallas_interpret(data, group, dead):
    valid = data["valid"] if dead else np.ones(N, np.float32)
    want = ref_pallas.pq4_adc_grouped(
        jnp.asarray(data["q"]), jnp.asarray(data["packed"]), jnp.asarray(data["cent"]),
        jnp.asarray(valid), group=group, block_rows=512, interpret=True)
    got = port_pallas.pq4_adc_grouped(
        _t(data["q"]), _t(data["packed"]), _t(data["cent"]), _t(valid),
        group=group, block_rows=512)
    assert got[0].shape == (B, N // group) and got[1].dtype == torch.int32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    # rows: equal wherever the window's best two rows differ by more than
    # 1e-5 (scores recomputed from the reference's own LUT sums)
    scores = np.asarray(ref_pallas.pq4_adc_grouped(
        jnp.asarray(data["q"]), jnp.asarray(data["packed"]), jnp.asarray(data["cent"]),
        jnp.asarray(valid), group=1, block_rows=512, interpret=True)[0])
    top2 = -np.sort(-scores.reshape(B, -1, group), axis=2)[:, :, :2]
    sure = (top2[:, :, 0] - top2[:, :, 1]) > 1e-5
    np.testing.assert_array_equal(got[1].numpy()[sure], np.asarray(want[1])[sure])
    if dead:
        assert (got[0].numpy() <= -1e29).any()


@pytest.mark.parametrize("sel_width", [0, 64])
def test_pq4_adc_topk_pallas_matches_reference(data, sel_width):
    want = ref_pallas.pq4_adc_topk_pallas(
        jnp.asarray(data["q"]), jnp.asarray(data["packed"]), jnp.asarray(data["cent"]),
        jnp.asarray(data["valid"]), 32, group=8, block_rows=512, interpret=True,
        sel_width=sel_width)
    got = port_pallas.pq4_adc_topk_pallas(
        _t(data["q"]), _t(data["packed"]), _t(data["cent"]), _t(data["valid"]), 32,
        group=8, block_rows=512, sel_width=sel_width)
    _assert_windows_equal(*got, *want)
    dead = set(np.nonzero(data["valid"] == 0)[0].tolist())
    assert not set(got[1].numpy().ravel().tolist()) & dead


def test_pq4_adc_cuda_refuses_cpu_tensors(data):
    lut = port_pq.pq_lut(_t(data["q"]), _t(data["cent"])).bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        port_pallas.pq4_adc_cuda(lut, _t(data["packed"]), _t(data["valid"]), 8, 512)


# Edges of the CUDA kernel's design, held on the twin against the Pallas
# kernel: the subspace counts that pick each query-tile width (m 8 and 32:
# 128 queries a block; 96: 64), groups inside a warp (8) and across two
# 128-row tiles (256), and query tiles at B 1, 127 and 129. Random codes and
# centroids; a dead 128-row tile. Tolerances as above: values to 1e-5, rows
# equal wherever a window's best two differ by more than 1e-5.
K4_N = 2048


def _k4_edge_inputs(m: int, bq: int, seed: int = 11, dsub: int = 2):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((m, 16, dsub)).astype(np.float32)
    packed = rng.integers(0, 256, (K4_N, m // 2), dtype=np.uint8)
    valid = np.ones(K4_N, np.float32)
    valid[rng.random(K4_N) < 0.05] = 0.0
    valid[256:384] = 0.0
    q = rng.standard_normal((bq, m * dsub)).astype(np.float32)
    return q, packed, cent, valid


@pytest.mark.parametrize("bq", [1, 127, 129])
@pytest.mark.parametrize("group", [8, 256])
@pytest.mark.parametrize("m", [8, 32, 96])
def test_k4_twin_matches_pallas_interpret_at_kernel_edges(m, group, bq):
    q, packed, cent, valid = _k4_edge_inputs(m, bq)
    want_v, want_i = ref_pallas.pq4_adc_grouped(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(cent), jnp.asarray(valid),
        group=group, block_rows=512, interpret=True)
    got_v, got_i = port_pallas.pq4_adc_grouped(_t(q), _t(packed), _t(cent), _t(valid),
                                               group=group, block_rows=512)
    assert got_v.shape == (bq, K4_N // group)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5, rtol=0)
    lut = port_pq.pq_lut(_t(q), _t(cent)).bfloat16()
    scores = port_pq.adc_scores(lut, port_pq.pq4_unpack(_t(packed))).numpy()
    scores += ((valid - 1.0) * 1e30)[None, :]
    top2 = -np.sort(-scores.reshape(bq, -1, group), axis=2)[:, :, :2]
    sure = (top2[:, :, 0] - top2[:, :, 1]) > 1e-5
    np.testing.assert_array_equal(got_i.numpy()[sure], np.asarray(want_i)[sure])
    if group == 8:                  # the dead tile's windows: (-1e30, their first row)
        cols = np.arange(256 // 8, 384 // 8)
        assert (got_v.numpy()[:, cols] <= -1e29).all()
        assert (got_i.numpy()[:, cols] == cols * 8).all()
