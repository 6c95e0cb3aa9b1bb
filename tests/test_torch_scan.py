"""Port parity: the exact KNN scan and its block kernel K3 (ops/scan.py).

Seeded NumPy corpora go through yams_tpu's dense_scores / exact_topk_scan /
exact_topk_pallas (the Pallas kernel in interpret mode on the CPU, as
tests/test_ops.py runs it) and the port's, whose block step on a CPU tensor
is the plain twin `exact_topk_reference`. Values agree to 1e-5 (f32 sums of
bf16 products in another order); ids agree wherever the value is above
-1e29, and the K3 block step's -1e30 slots hold the same repeated block
start (hazard H2: the knock-out value equals the masked score).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from yams_tpu.ops import scan as ref_scan
from yams_tpu_torch.ops import scan as port_scan

N, D, B, BR = 2048, 64, 4, 512
K_CASES = (1, 10, 33)
CASES = ("random", "duplicates", "dead_block", "k_minus_1_live", "sparse")


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(case: str, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    E = _unit(rng.standard_normal((N, D)))
    q = _unit(rng.standard_normal((B, D)))
    valid = np.ones(N, np.float32)
    valid[rng.random(N) < 0.05] = 0.0
    if case == "duplicates":
        # exact ties at the top of every query, inside and across blocks
        for b in range(B):
            E[[11 + b, 700 + b, 1500 + b, 1501 + b]] = q[b]
        E[900:940] = E[20:60]
    elif case == "dead_block":
        valid[BR:2 * BR] = 0.0
    elif case == "k_minus_1_live":
        valid[2 * BR:3 * BR] = 0.0
        valid[2 * BR + rng.choice(BR, k - 1, replace=False)] = 1.0
    elif case == "sparse":          # fewer than k live rows in the corpus
        valid[:] = 0.0
        valid[rng.choice(N, k - 1, replace=False)] = 1.0
    return q, E, valid


def _ref_blocks(q, E, valid, k):
    """The reference's K3 block step alone: (G, B, k) values and rows."""
    G = N // BR
    return pl.pallas_call(
        functools.partial(ref_scan._topk_block_kernel, k=k),
        grid=(G,),
        in_specs=[pl.BlockSpec((B, D), lambda i: (0, 0)),
                  pl.BlockSpec((BR, D), lambda i: (i, 0)),
                  pl.BlockSpec((BR,), lambda i: (i,))],
        out_specs=(pl.BlockSpec((1, B, k), lambda i: (i, 0, 0)),
                   pl.BlockSpec((1, B, k), lambda i: (i, 0, 0))),
        out_shape=(jax.ShapeDtypeStruct((G, B, k), jnp.float32),
                   jax.ShapeDtypeStruct((G, B, k), jnp.int32)),
        interpret=True,
    )(jnp.asarray(q, jnp.bfloat16), jnp.asarray(E, jnp.bfloat16), jnp.asarray(valid))


def _assert_topk_equal(got_v, got_i, want_v, want_i):
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, atol=1e-5, rtol=0)
    live = want_v > -1e29
    np.testing.assert_array_equal(got_i[live], want_i[live])


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if dtype is not None else t


def test_dense_scores_match_reference():
    q, E, valid = _inputs("random", 10)
    want = ref_scan.dense_scores(jnp.asarray(q), jnp.asarray(E), jnp.asarray(valid))
    got = port_scan.dense_scores(_t(q), _t(E), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", K_CASES)
@pytest.mark.parametrize("case", CASES)
def test_exact_topk_scan_matches_reference(case, k):
    q, E, valid = _inputs(case, k)
    want = ref_scan.exact_topk_scan(jnp.asarray(q), jnp.asarray(E, jnp.bfloat16),
                                    jnp.asarray(valid), k=k, block_rows=BR)
    got = port_scan.exact_topk_scan(_t(q), _t(E, torch.bfloat16), _t(valid), k,
                                    block_rows=BR)
    _assert_topk_equal(*got, *want)
    # below -1e29 both carry the initial (-1e30, -1) entries
    assert np.array_equal(got[1].numpy()[np.asarray(want[0]) <= -1e29],
                          np.asarray(want[1])[np.asarray(want[0]) <= -1e29])


@pytest.mark.parametrize("k", K_CASES)
@pytest.mark.parametrize("case", CASES)
def test_k3_block_twin_matches_pallas_interpret(case, k):
    q, E, valid = _inputs(case, k)
    want_v, want_i = _ref_blocks(q, E, valid, k)
    got_v, got_i = port_scan.exact_topk_reference(
        _t(q, torch.bfloat16), _t(E, torch.bfloat16), _t(valid), k, BR)
    _assert_topk_equal(got_v, got_i, want_v, want_i)
    # H2: the -1e30 slots repeat the block's first row, as on the TPU
    dead = np.asarray(want_v) <= -1e29
    np.testing.assert_array_equal(got_i.numpy()[dead], np.asarray(want_i)[dead])
    starts = np.arange(N // BR)[:, None, None] * BR
    assert np.all(np.broadcast_to(starts, dead.shape)[dead] == np.asarray(want_i)[dead])
    if case in ("dead_block", "k_minus_1_live", "sparse"):
        assert dead.any()


@pytest.mark.parametrize("k", K_CASES)
@pytest.mark.parametrize("case", CASES)
def test_exact_topk_pallas_matches_reference(case, k):
    q, E, valid = _inputs(case, k)
    want = ref_scan.exact_topk_pallas(jnp.asarray(q), jnp.asarray(E, jnp.bfloat16),
                                      jnp.asarray(valid), k=k, block_rows=BR,
                                      interpret=True)
    got = port_scan.exact_topk_pallas(_t(q), _t(E, torch.bfloat16), _t(valid), k,
                                      block_rows=BR)
    _assert_topk_equal(*got, *want)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_exact_topk_cuda_refuses_cpu_tensors():
    q, E, valid = _inputs("random", 10)
    with pytest.raises(ValueError, match="CUDA"):
        port_scan.exact_topk_cuda(_t(q, torch.bfloat16), _t(E, torch.bfloat16),
                                  _t(valid), 10, BR)
