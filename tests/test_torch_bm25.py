"""Port parity: BM25 top-C candidates and the selection/scan helpers.

yams_tpu_torch.ops.bm25 against yams_tpu.ops.bm25 (XLA on the CPU) on seeded
NumPy postings. Ids are compared exactly; the CSR path's scores too, to
atol 1e-6. The packed path's scores agree to 1e-6 plus 8 f32 ulps of the
query's total impact mass: the reference's XLA program recomputes the
prefix sum inside a second fusion for the segment bases, so a segment sum
there can sit a few ulps of the running total (not of the score) away from
the port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yams_tpu.ops import bm25 as ref_bm25
from yams_tpu_torch.ops import bm25 as port_bm25
from yams_tpu_torch.ops.select import prefix_sum, top_k

ND, V, W, T, B = 512, 300, 64, 8, 6


def _postings(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, W + 1, V).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    P = int(lens.sum())
    docs = rng.integers(0, ND, P).astype(np.int32)
    imp = np.zeros(P, np.float32)
    for o, n in zip(offs, lens):   # impact-descending inside each term
        imp[o:o + n] = np.sort(rng.gamma(2.0, 1.5, n).astype(np.float32))[::-1]
    docs = np.concatenate([docs, np.full(W, ND, np.int32)])   # sink padding
    imp = np.concatenate([imp, np.zeros(W, np.float32)])
    return docs, imp, offs, lens


def _query(seed=1, fractional=True):
    rng = np.random.default_rng(seed)
    tids = rng.integers(0, V, (B, T)).astype(np.int32)
    weights = [0.0, 0.6, 1.0] if fractional else [0.0, 1.0]
    tmask = rng.choice(weights, (B, T)).astype(np.float32)
    tmask[0] = 0.0                          # a query with no live term
    return tids, tmask


def test_pack_postings_2d_and_qbits_match_reference():
    docs, imp, offs, lens = _postings()
    for n in (1, 2, 1000, ND, 1 << 20):
        assert port_bm25.packed_qbits(n) == ref_bm25.packed_qbits(n)
    got, gs = port_bm25.pack_postings_2d(docs, imp, offs, lens, window=W, num_docs=ND)
    want, ws = ref_bm25.pack_postings_2d(docs, imp, offs, lens, window=W, num_docs=ND)
    assert np.array_equal(got, want) and gs == ws


@pytest.mark.parametrize("prefilter", [0, 16])
@pytest.mark.parametrize("fractional", [False, True])
def test_packed_candidates_match_reference(prefilter, fractional):
    docs, imp, offs, lens = _postings()
    packed, scale = ref_bm25.pack_postings_2d(docs, imp, offs, lens, window=W, num_docs=ND)
    tids, tmask = _query(fractional=fractional)
    kw = dict(num_docs=ND, num_candidates=32, prefilter=prefilter)
    wi, ws = ref_bm25.bm25_topk_candidates_packed(
        jnp.asarray(tids), jnp.asarray(tmask), jnp.asarray(packed),
        jnp.asarray(np.float32(scale)), **kw)
    gi, gs = port_bm25.bm25_topk_candidates_packed(
        torch.from_numpy(tids), torch.from_numpy(tmask), torch.from_numpy(packed),
        torch.tensor(np.float32(scale)), **kw)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    qmax = (1 << ref_bm25.packed_qbits(ND)) - 1
    take = prefilter or W
    live = (packed[tids, :take] & qmax) * np.clip(tmask, 0, 1)[:, :, None]
    mass = (live * (scale / qmax)).reshape(B, -1).sum(axis=1, keepdims=True)
    tol = 1e-6 + 8 * np.spacing(mass.astype(np.float32))
    assert (np.abs(gs.numpy() - np.asarray(ws)) <= tol).all()
    assert (gi.numpy()[0] == ND).all()      # no live term -> all sink


@pytest.mark.parametrize("prefilter", [0, 16])
def test_csr_candidates_match_reference(prefilter):
    docs, imp, offs, lens = _postings(2)
    tids, tmask = _query(3)
    kw = dict(window=W, num_docs=ND, num_candidates=32, prefilter=prefilter)
    wi, ws = ref_bm25.bm25_topk_candidates(
        *(jnp.asarray(x) for x in (tids, tmask, docs, imp, offs, lens)), **kw)
    gi, gs = port_bm25.bm25_topk_candidates(
        *(torch.from_numpy(x) for x in (tids, tmask, docs, imp, offs, lens)), **kw)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 100, 257, 4096])
def test_prefix_sum_is_bitwise_jnp_cumsum(n):
    x = (np.random.default_rng(n).random((3, n)) * 5).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(jnp.asarray(x)))
    assert np.array_equal(prefix_sum(torch.from_numpy(x)).numpy(), want)


def test_top_k_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(0)
    x = rng.choice([-1e30, -2.5, -0.0, 0.0, 1.0, 3.0], (5, 40)).astype(np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 12)
    gv, gi = top_k(torch.from_numpy(x), 12)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gv.numpy(), np.asarray(wv))
