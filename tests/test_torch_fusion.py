"""Port parity: the hybrid query program (yams_tpu_torch.search.fusion).

Seeded NumPy corpora, postings and queries go through yams_tpu's
hybrid_query / hybrid_fuse_precomputed (XLA on the CPU) and the port's.
Fused slots must be equal (the port keeps lax.top_k's tie order and
jnp.cumsum's summation order) and fused scores agree to atol 1e-5: the
vector scores are f32 sums of bf16 products taken in another order, and the
adaptive leg weights divide by 1 - mean(normalized scores), which magnifies
those ulps. The same holds for the int8 corpus (the query is quantized from
those f32 embeddings), the streaming blocked scan and the chunk
aggregations "sum" (segment sums in another order: a few ulps),
"topk_avg" and "weighted_topk_avg". Those new tiers' cases run the CSR
lexical leg: the packed leg's BM25 sums sit up to 8 ulps of the query's
impact mass away from the reference's (tests/test_torch_bm25.py), more than
bm25_at's 1e-5 on some seeds, and the tiers under test do not touch it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yams_tpu.ops.bm25 import pack_postings_2d
from yams_tpu.ops.scan import quantize_int8
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


def _int8(x):
    """The same inputs with the corpus as int8 codes and per-row scales."""
    q8, scale = quantize_int8(x["E"])
    return dict(x, E=q8, scale=scale)


def _run_both(x, packed, idx=None, **kw):
    if packed:
        pk, sc = pack_postings_2d(x["pdoc"], x["pimp"], x["offs"], x["lens"],
                                  window=W, num_docs=ND)
        x = dict(x, pdoc=pk, pimp=np.float32(sc))
    ja = [jnp.asarray(x[n]) for n in ORDER]
    ta = [torch.as_tensor(np.asarray(x[n])) for n in ORDER]
    ja[3], ta[3] = ja[3].astype(jnp.bfloat16), ta[3].bfloat16()
    if x["E"].dtype != np.int8:
        ja[4], ta[4] = ja[4].astype(jnp.bfloat16), ta[4].bfloat16()
    if idx is not None:
        ja.append(jnp.asarray(idx))
        ta.append(torch.from_numpy(idx))
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
    """These tiers refused (NotImplementedError) until the port had them;
    each now matches the reference on the same inputs."""
    x = _inputs(True)
    if opts.get("int8_corpus"):
        x = _int8(x)
    want, got = _run_both(x, packed=True, **opts)
    _assert_same(want, got)


# -- the streaming blocked scan ----------------------------------------------------
BLOCK = 64          # 4 blocks of the 256-row flat corpus
MASKS = ("shared", "per_query", "filter_rows")


def _streaming_inputs(dtype, mask, seed=7):
    """A flat corpus with some dead rows and the mask in one of its three
    forms: shared (num_slots,), per-query (B, num_slots) f32, or U uint8
    rows with a per-query row index."""
    x = _inputs(True, seed=seed)
    rng = np.random.default_rng(seed + 100)
    x["valid"][rng.random(ND) < 0.05] = 0.0
    idx = None
    if mask == "per_query":
        x["doc_mask"] = (rng.random((B, ND)) > 0.3).astype(np.float32)
    elif mask == "filter_rows":
        x["doc_mask"] = (rng.random((4, ND)) > 0.5).astype(np.uint8)
        idx = rng.integers(0, 4, B).astype(np.int32)
    return (_int8(x) if dtype == "int8" else x), idx


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_streaming_scan_matches_reference(dtype, mask):
    """Streaming against the reference's streaming program, and against the
    port's own materialized program on the same inputs (every block's
    top-C merged into the carry is the global top-C where C rows live)."""
    x, idx = _streaming_inputs(dtype, mask)
    kw = dict(rows_are_docs=True, int8_corpus=dtype == "int8")
    want, got = _run_both(x, packed=False, idx=idx, scan_block_rows=BLOCK, **kw)
    _assert_same(want, got)
    _, dense = _run_both(x, packed=False, idx=idx, **kw)
    _assert_same(dense, got)


def _reference_carry(q, E, valid, scale, dm, C, sink, block, int8_corpus):
    """The reference's streaming vector leg (yams_tpu/search/fusion.py,
    the lax.scan under `scan_block_rows`), as JAX ops on the CPU, returning
    its merged carry: hybrid_query itself does not expose it."""
    import jax

    vv = jnp.full((q.shape[0], C), -1e30, jnp.float32)
    vi = jnp.full((q.shape[0], C), sink, jnp.int32)
    if int8_corpus:
        qscale = jnp.maximum(jnp.max(jnp.abs(q), axis=1), 1e-12) / 127.0
        q8 = jnp.clip(jnp.round(q / qscale[:, None]), -127, 127).astype(jnp.int8)
    for g in range(E.shape[0] // block):
        sl = slice(g * block, (g + 1) * block)
        if int8_corpus:
            s = jax.lax.dot_general(q8, E[sl], (((1,), (1,)), ((), ())),
                                    preferred_element_type=jnp.int32)
            s = s.astype(jnp.float32) * qscale[:, None] * scale[sl][None, :]
        else:
            s = jnp.dot(q.astype(jnp.bfloat16), E[sl].T, preferred_element_type=jnp.float32)
        s = s + (valid[sl] - 1.0)[None, :] * 1e30 + (dm[:, sl] - 1.0) * 1e30
        bv, bi = jax.lax.top_k(s, C)
        nv, pos = jax.lax.top_k(jnp.concatenate([vv, bv], axis=1), C)
        vi = jnp.take_along_axis(jnp.concatenate([vi, bi + g * block], axis=1), pos, axis=1)
        vv = nv
    return np.asarray(vv), np.asarray(vi)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_streaming_scan_fewer_live_rows_than_c_keeps_sink_ids(dtype):
    """Only 5 live docs for C = 16: the carry's (-1e30, sink) entries win
    every tie with a masked row's -1e30, so the merged candidates end in
    sink ids. The port's carry equals the reference's, then the fused
    outputs do."""
    x, _ = _streaming_inputs(dtype, "shared", seed=9)
    x["doc_mask"][:] = 0.0
    x["doc_mask"][[3, 40, 77, 130, 250]] = 1.0
    int8 = dtype == "int8"
    q = torch.from_numpy(x["sketch"]) @ torch.from_numpy(x["proj"]).bfloat16().float()
    q = q / q.norm(dim=-1, keepdim=True)
    E = torch.from_numpy(x["E"]) if int8 else torch.from_numpy(x["E"]).bfloat16()
    valid, scale = torch.from_numpy(x["valid"]), torch.from_numpy(x["scale"])

    def scores(lo, hi):
        if int8:
            q8, qs = port_fusion.quantize_rows(q)
            s = port_fusion.int8_product(q8, qs, E[lo:hi], scale[lo:hi])
        else:
            s = port_fusion.dot_f32(q, E[lo:hi])
        return s + ((valid[lo:hi] - 1.0) * 1e30)[None, :]

    gv, gi = port_fusion._streaming_top_c(scores, ND, B, torch.from_numpy(x["doc_mask"]),
                                          None, 16, ND, BLOCK)
    Ej = jnp.asarray(x["E"]) if int8 else jnp.asarray(x["E"], jnp.bfloat16)
    wv, wi = _reference_carry(jnp.asarray(q.numpy()), Ej, jnp.asarray(x["valid"]),
                              jnp.asarray(x["scale"]), jnp.asarray(x["doc_mask"])[None, :],
                              16, ND, BLOCK, int8)
    assert np.array_equal(gi.numpy(), wi)
    assert (wi[:, 5:] == ND).all() and (wv[:, 5:] == np.float32(-1e30)).all()
    np.testing.assert_allclose(gv.numpy(), wv, atol=1e-5, rtol=0)
    want, got = _run_both(x, packed=False, rows_are_docs=True, int8_corpus=int8,
                          scan_block_rows=BLOCK)
    _assert_same(want, got)


def test_streaming_scan_checks_its_layout():
    x, _ = _streaming_inputs("bf16", "shared")
    ta = [torch.as_tensor(np.asarray(x[n])) for n in ORDER]
    ta[3], ta[4] = ta[3].bfloat16(), ta[4].bfloat16()
    kw = dict(k=10, rrf_cand=16, window=W, num_slots=ND, rows_are_docs=True)
    with pytest.raises(ValueError, match="scan_block_rows"):
        port_fusion.hybrid_query(*ta, scan_block_rows=96, **kw)
    ta[12] = ta[12][:128]
    with pytest.raises(ValueError, match="by row"):
        port_fusion.hybrid_query(*ta, scan_block_rows=BLOCK, **kw)


# -- the materialized int8 corpus and the chunk aggregations -----------------------
@pytest.mark.parametrize("rows_are_docs", [True, False])
def test_int8_corpus_matches_reference(rows_are_docs):
    want, got = _run_both(_int8(_inputs(rows_are_docs, seed=11)), packed=False,
                          rows_are_docs=rows_are_docs, int8_corpus=True)
    _assert_same(want, got)


def _tied_chunks(seed):
    """A chunked corpus in which doc 5 holds exactly two chunks, rows 3 and
    7, with identical vectors: they tie at the doc's max for every query,
    and both are knocked out of the second max."""
    x = _inputs(False, seed=seed)
    r2s = x["r2s"]
    r2s[r2s == 5] = 6
    r2s[[3, 7]] = 5
    x["valid"][[3, 7]] = 1.0
    return x


@pytest.mark.parametrize("chunk_agg", ["sum", "topk_avg", "weighted_topk_avg"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_chunk_agg_matches_reference(chunk_agg, dtype):
    x = _tied_chunks(seed=13)
    if dtype == "int8":
        x = _int8(x)
    want, got = _run_both(x, packed=False, chunk_agg=chunk_agg,
                          int8_corpus=dtype == "int8")
    _assert_same(want, got)
    assert (got[1] == 5).any()        # the tied doc reaches the fused top-k


@pytest.mark.parametrize("chunk_agg", ["sum", "topk_avg", "weighted_topk_avg"])
def test_chunk_agg_with_filter_rows(chunk_agg):
    """A chunk aggregation beside deduplicated per-query filter rows."""
    x = _tied_chunks(seed=15)
    rng = np.random.default_rng(16)
    x["doc_mask"] = (rng.random((4, ND)) > 0.3).astype(np.uint8)
    idx = rng.integers(0, 4, B).astype(np.int32)
    want, got = _run_both(x, packed=False, idx=idx, chunk_agg=chunk_agg)
    _assert_same(want, got)


def test_unknown_chunk_agg_raises():
    x = _inputs(False)
    ta = [torch.as_tensor(np.asarray(x[n])) for n in ORDER]
    ta[3], ta[4] = ta[3].bfloat16(), ta[4].bfloat16()
    with pytest.raises(ValueError, match="chunk_agg"):
        port_fusion.hybrid_query(*ta, k=10, rrf_cand=16, window=W, num_slots=ND,
                                 chunk_agg="median")


def test_row_norm_does_not_depend_on_the_summation_order():
    """The query norm is the same bits whatever order its squares are
    summed in (so on the card and on the CPU), and within an f32 ulp of the
    plain norm."""
    rng = np.random.default_rng(17)
    q = rng.standard_normal((64, 384)).astype(np.float32)
    q[:8] = np.round(q[:8] * 4) / 4                  # sketch-like: few distinct values
    want = port_fusion._row_norm(torch.from_numpy(q))
    for perm in (np.arange(384)[::-1], rng.permutation(384)):
        assert torch.equal(port_fusion._row_norm(torch.from_numpy(q[:, perm].copy())), want)
    np.testing.assert_allclose(want.numpy()[:, 0], np.linalg.norm(q, axis=1), rtol=2e-7)
