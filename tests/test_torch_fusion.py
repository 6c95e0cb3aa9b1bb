"""Port parity: the hybrid query program (yams_tpu_torch.search.fusion).

Seeded NumPy corpora, postings and queries go through yams_tpu's
hybrid_query / hybrid_fuse_precomputed (XLA on the CPU) and the port's.
Fused slots must be equal (the port keeps lax.top_k's tie order and
jnp.cumsum's summation order) and fused scores agree to atol 1e-5: the
vector scores are f32 sums of bf16 products taken in another order, and the
adaptive leg weights divide by 1 - mean(normalized scores), which magnifies
those ulps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yams_tpu.ops.bm25 import pack_postings_2d
from yams_tpu.search import fusion as ref_fusion
from yams_tpu.search.config import SearchEngineConfig as RefConfig
from yams_tpu_torch.search import fusion as port_fusion
from yams_tpu_torch.search.config import SearchEngineConfig

B, S, D, ND, V, W, T = 8, 96, 32, 256, 200, 64, 6


def _inputs(rows_are_docs, seed=0):
    rng = np.random.default_rng(seed)
    rows = ND if rows_are_docs else 512
    sketch = rng.standard_normal((B, S)).astype(np.float32)
    proj = (np.sign(rng.standard_normal((S, D))) / np.sqrt(D)).astype(np.float32)
    E = rng.standard_normal((rows, D)).astype(np.float32)
    E[7] = E[3]                              # exact vector-score ties
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    valid = np.ones(rows, np.float32)
    if rows_are_docs:
        r2s = np.arange(rows, dtype=np.int32)
    else:
        valid[rng.random(rows) < 0.05] = 0.0
        r2s = rng.integers(0, ND - 16, rows).astype(np.int32)
        r2s[valid == 0] = -1
    lens = rng.integers(0, W + 1, V).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    P = int(lens.sum())
    pdoc = np.concatenate([rng.integers(0, ND, P), np.full(W, ND)]).astype(np.int32)
    pimp = np.zeros(P + W, np.float32)
    for o, n in zip(offs, lens):
        pimp[o:o + n] = np.sort(rng.gamma(2.0, 1.5, n))[::-1]
    tids = rng.integers(0, V, (B, T)).astype(np.int32)
    tmask = rng.choice([0.0, 0.6, 1.0], (B, T)).astype(np.float32)
    doc_mask = np.ones(ND, np.float32)
    doc_mask[rng.random(ND) < 0.1] = 0.0
    hot = np.zeros(ND, np.float32)
    hot[:5] = 0.5
    w = port_fusion.pack_weights(SearchEngineConfig())
    return dict(sketch=sketch, tids=tids, tmask=tmask, proj=proj, E=E,
                valid=valid, r2s=r2s, scale=np.ones(rows, np.float32),
                pdoc=pdoc, pimp=pimp, offs=offs, lens=lens,
                doc_mask=doc_mask, hot=hot, w=w)


ORDER = ("sketch", "tids", "tmask", "proj", "E", "valid", "r2s", "scale",
         "pdoc", "pimp", "offs", "lens", "doc_mask", "hot", "w")


def _run_both(x, packed, **kw):
    if packed:
        pk, sc = pack_postings_2d(x["pdoc"], x["pimp"], x["offs"], x["lens"],
                                  window=W, num_docs=ND)
        x = dict(x, pdoc=pk, pimp=np.float32(sc))
    ja = [jnp.asarray(x[n]) for n in ORDER]
    ja[3] = ja[3].astype(jnp.bfloat16)
    ja[4] = ja[4].astype(jnp.bfloat16)
    ta = [torch.as_tensor(np.asarray(x[n])) for n in ORDER]
    ta[3] = ta[3].bfloat16()
    ta[4] = ta[4].bfloat16()
    kw = dict(kw, k=20, rrf_cand=16, window=W, num_slots=ND, packed_lexical=packed)
    want = [np.asarray(a) for a in ref_fusion.hybrid_query(*ja, **kw)]
    got = [a.numpy() for a in port_fusion.hybrid_query(*ta, **kw)]
    return want, got


def _assert_same(want, got):
    wv, ws, wb, wvec = want
    gv, gs, gb, gvec = got
    assert np.array_equal(gs, ws)
    np.testing.assert_allclose(gv, wv, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb, wb, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(gvec, wvec, atol=1e-5, rtol=0)


def test_pack_weights_matches_reference():
    for cfg in (RefConfig(), RefConfig(text_weight=0.7, rrf_k=60, leg_adaptive=0.0)):
        assert np.array_equal(port_fusion.pack_weights(cfg), ref_fusion.pack_weights(cfg))


@pytest.mark.parametrize("rows_are_docs", [True, False])
@pytest.mark.parametrize("approx", [False, True])
def test_hybrid_query_matches_reference(rows_are_docs, approx):
    x = _inputs(rows_are_docs)
    want, got = _run_both(x, packed=True, rows_are_docs=rows_are_docs,
                          approx=approx, chunk_agg="max")
    _assert_same(want, got)


def test_hybrid_query_csr_prefilter_and_filter_rows():
    """CSR lexical leg, a BM25 prefilter, and deduplicated per-query filter
    rows (mask_idx) in one program."""
    x = _inputs(False, seed=3)
    rng = np.random.default_rng(4)
    masks = (rng.random((4, ND)) > 0.3).astype(np.uint8)
    idx = rng.integers(0, 4, B).astype(np.int32)
    ja = [jnp.asarray(x[n]) for n in ORDER]
    ja[3] = ja[3].astype(jnp.bfloat16)
    ja[4] = ja[4].astype(jnp.bfloat16)
    ja[12] = jnp.asarray(masks)
    ta = [torch.as_tensor(np.asarray(x[n])) for n in ORDER]
    ta[3] = ta[3].bfloat16()
    ta[4] = ta[4].bfloat16()
    ta[12] = torch.from_numpy(masks)
    kw = dict(k=20, rrf_cand=16, window=W, num_slots=ND, bm25_prefilter=16)
    want = [np.asarray(a) for a in ref_fusion.hybrid_query(*ja, jnp.asarray(idx), **kw)]
    got = [a.numpy() for a in port_fusion.hybrid_query(*ta, torch.from_numpy(idx), **kw)]
    _assert_same(want, got)


def test_hybrid_fuse_precomputed_matches_reference():
    x = _inputs(True, seed=5)
    rng = np.random.default_rng(6)
    vv = np.sort(rng.random((B, 16)).astype(np.float32), axis=1)[:, ::-1].copy()
    vi = rng.integers(0, ND + 1, (B, 16)).astype(np.int32)   # ND = absent
    pk, sc = pack_postings_2d(x["pdoc"], x["pimp"], x["offs"], x["lens"],
                              window=W, num_docs=ND)
    names = ("tids", "tmask")
    kw = dict(k=20, rrf_cand=16, window=W, num_slots=ND, packed_lexical=True)
    want = ref_fusion.hybrid_fuse_precomputed(
        *(jnp.asarray(x[n]) for n in names), jnp.asarray(pk), jnp.asarray(np.float32(sc)),
        jnp.asarray(x["offs"]), jnp.asarray(x["lens"]), jnp.asarray(x["doc_mask"]),
        jnp.asarray(x["hot"]), jnp.asarray(x["w"]), jnp.asarray(vv), jnp.asarray(vi), **kw)
    got = port_fusion.hybrid_fuse_precomputed(
        *(torch.from_numpy(x[n]) for n in names), torch.from_numpy(pk),
        torch.tensor(np.float32(sc)), torch.from_numpy(x["offs"]),
        torch.from_numpy(x["lens"]), torch.from_numpy(x["doc_mask"]),
        torch.from_numpy(x["hot"]), torch.from_numpy(x["w"]), torch.from_numpy(vv),
        torch.from_numpy(vi), **kw)
    _assert_same([np.asarray(a) for a in want], [a.numpy() for a in got])


@pytest.mark.parametrize("opts", [
    {"scan_block_rows": 128, "rows_are_docs": True},
    {"int8_corpus": True},
    {"chunk_agg": "sum"},
    {"chunk_agg": "topk_avg"},
])
def test_unported_tiers_refuse(opts):
    x = _inputs(True)
    ta = [torch.as_tensor(np.asarray(x[n])) for n in ORDER]
    ta[3] = ta[3].bfloat16()
    ta[4] = ta[4].bfloat16()
    with pytest.raises(NotImplementedError):
        port_fusion.hybrid_query(*ta, k=10, rrf_cand=16, window=W,
                                 num_slots=ND, **opts)
