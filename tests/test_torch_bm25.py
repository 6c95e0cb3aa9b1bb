"""Port parity: BM25 top-C candidates and the selection/scan helpers.

yams_tpu_torch.ops.bm25 against yams_tpu.ops.bm25 (XLA on the CPU) on seeded
NumPy postings. Ids are compared exactly; the CSR path's scores too, to
atol 1e-6. The packed path's scores agree to 1e-6 plus 8 f32 ulps of the
query's total impact mass: the reference's XLA program recomputes the
prefix sum inside a second fusion for the segment bases, so a segment sum
there can sit a few ulps of the running total (not of the score) away from
the port's.

The standalone dense scan (`bm25_dense`, item 12): the port's loop, called
directly and through `bm25_dense_from`, equals JAX's `bm25_dense` exactly
where each doc occurs once per term, over padded and unpadded postings (a term near the end of unpadded
postings reads the reference's shifted window), fractional term weights,
masked terms and doc ids at and past the sink; with repeated docs inside
a term they stay within 1e-6 of the largest score with the same top-10
ids. `LexicalIndex.search` answers as the reference's, and the reference's
postings-window contract tests rerun on the port's index.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_bm25_window_contract as contract
from yams_tpu.ops import bm25 as ref_bm25
from yams_tpu_torch.index.lexical_index import LexicalIndex as PortLexical
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


def _dense_inputs(seed, pad: bool, unique: bool, n_docs=ND):
    """Seeded CSR postings with tf and doc norms, and (B, T) queries whose
    first row names the last terms (the end-of-postings window)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, W + 1, V).astype(np.int32)
    lens[-3:] = [W // 2, 3, W - 5]
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    docs = np.concatenate([rng.permutation(n_docs)[:n] if unique
                           else rng.integers(0, n_docs // 8, n) for n in lens]).astype(np.int32)
    tf = rng.gamma(2.0, 1.5, len(docs)).astype(np.float32)
    if pad:
        docs = np.concatenate([docs, np.full(W, n_docs, np.int32)])
        tf = np.concatenate([tf, np.zeros(W, np.float32)])
    dn = rng.uniform(0.4, 1.8, n_docs).astype(np.float32)
    idf = rng.uniform(0.05, 4.0, V).astype(np.float32)
    tids = rng.integers(0, V, (B, T)).astype(np.int32)
    tids[0, :3] = [V - 1, V - 2, V - 1]          # the clip, and a term twice
    tmask = rng.choice([0.0, 0.35, 1.0], (B, T)).astype(np.float32)
    tmask[0, :3] = 1.0
    tmask[1] = 0.0                               # no live term
    return tids, tmask, docs, tf, offs, lens, dn, idf


def _ref_dense(arrs, n_docs=ND):
    return np.asarray(ref_bm25.bm25_dense(*(jnp.asarray(a) for a in arrs), window=W,
                                          num_docs=n_docs))


def _port_dense(entry, arrs, n_docs=ND):
    """The port's scan through `bm25_dense` or through `bm25_dense_from` on
    a Bm25Arrays holding the same postings."""
    tids, tmask, docs, tf, offs, lens, dn, idf = (torch.from_numpy(a) for a in arrs)
    if entry == "bm25_dense":
        return port_bm25.bm25_dense(tids, tmask, docs, tf, offs, lens, dn, idf,
                                    window=W, num_docs=n_docs).numpy()
    view = port_bm25.Bm25Arrays(postings_doc=docs, postings_impact=torch.zeros_like(tf),
                                term_offsets=offs, term_lengths=lens, num_docs=n_docs,
                                postings_tf=tf, doc_norm=dn, idf=idf)
    return port_bm25.bm25_dense_from(view, tids, tmask, window=W).numpy()


@pytest.mark.parametrize("route", ["bm25_dense", "bm25_dense_from"])
@pytest.mark.parametrize("pad", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bm25_dense_matches_reference_exactly(route, pad, seed):
    arrs = _dense_inputs(seed, pad, unique=True)
    got = _port_dense(route, arrs)
    want = _ref_dense(arrs)
    assert got.shape == want.shape == (B, ND)
    assert np.array_equal(got, want)
    assert (got[1] == 0).all() and (got[0] > 0).any()


@pytest.mark.parametrize("route", ["bm25_dense", "bm25_dense_from"])
def test_bm25_dense_with_repeated_docs_in_a_term(route):
    arrs = _dense_inputs(5, pad=True, unique=False)
    got = _port_dense(route, arrs)
    want = _ref_dense(arrs)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    top = lambda x: np.argsort(-x, axis=1, kind="stable")[:, :10]  # noqa: E731
    assert np.array_equal(top(got)[2:], top(want)[2:])


def test_bm25_dense_drops_the_sink_and_ids_past_it():
    """Postings naming the sink row N, or a doc past it, add nothing."""
    tids, tmask, docs, tf, offs, lens, dn, idf = _dense_inputs(7, pad=True, unique=True)
    docs = docs.copy()
    docs[offs[tids[2, 0]]] = ND                  # the sink
    docs[offs[tids[2, 0]] + 1] = ND + 7          # past it (XLA's mode="drop")
    arrs = (tids, tmask, docs, tf, offs, lens, dn, idf)
    for route in ("bm25_dense", "bm25_dense_from"):
        assert np.array_equal(_port_dense(route, arrs), _ref_dense(arrs))


def test_bm25_dense_is_bit_equal_to_jax_on_zipf_postings():
    """Phase 4's kind of data (zipf terms, every posting list impact-ordered,
    unique docs per term), the postings padded as LexicalIndex pads them."""
    rng = np.random.default_rng(11)
    n_docs, vocab = 5000, 400
    df = np.minimum(rng.zipf(1.3, vocab), n_docs // 4).astype(np.int32)
    take = np.minimum(df, W).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(take)[:-1]]).astype(np.int32)
    docs = np.concatenate([rng.permutation(n_docs)[:n] for n in take] +
                          [np.full(W, n_docs)]).astype(np.int32)
    tf = np.concatenate([rng.gamma(1.5, 2.0, len(docs) - W), np.zeros(W)]).astype(np.float32)
    dn = rng.uniform(0.5, 1.5, n_docs).astype(np.float32)
    idf = np.log1p((n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)
    tids = rng.integers(0, vocab, (16, 8)).astype(np.int32)
    tmask = np.ones((16, 8), np.float32)
    arrs = [torch.from_numpy(a) for a in (tids, tmask, docs, tf, offs, take, dn, idf)]
    a = port_bm25.bm25_dense(*arrs, window=W, num_docs=n_docs)
    want = np.asarray(ref_bm25.bm25_dense(*(jnp.asarray(x.numpy()) for x in arrs), window=W,
                                          num_docs=n_docs))
    assert np.array_equal(a.numpy(), want)


def _lexical_pair(cfg_kw=None):
    from yams_tpu.core.config import LexicalIndexConfig as RefCfg
    from yams_tpu.index.lexical_index import LexicalIndex as RefLexical
    from yams_tpu_torch.core.config import LexicalIndexConfig
    from yams_tpu_torch.index.lexical_index import LexicalIndex

    rng = np.random.default_rng(4)
    words = [f"t{i}" for i in range(300)] + ["route", "routing", "routed"]
    ref, port = RefLexical(RefCfg(**(cfg_kw or {}))), LexicalIndex(LexicalIndexConfig(
        **(cfg_kw or {})))
    for i in range(400):
        text = " ".join(words[z % len(words)] for z in rng.zipf(1.25, int(rng.integers(5, 80))))
        for idx in (ref, port):
            idx.add_document(i, text, title=words[i % len(words)])
    for idx in (ref, port):
        idx.remove_document(17)
    return ref, port


@pytest.mark.parametrize("cfg_kw", [{}, {"stem_expansion": False},
                                    {"postings_window": 16, "k1": 0.9}])
def test_lexical_index_search_matches_reference(cfg_kw):
    ref, port = _lexical_pair(cfg_kw)
    for q in ["t1 t2", "t3", "routing t5 t7 t11", "t0 t1 t2 t3 t4 t5 t6 t7 t8 t9", "zzz", "",
              "t250 routed"]:
        for k in (1, 10, 50):
            assert port.search(q, k=k, device="cpu") == ref.search(q, k=k), (q, k)


class _CpuLexical(PortLexical):
    """The port's LexicalIndex with `search` on the CPU, as the reference's
    contract tests call it (no device argument)."""

    def search(self, query, k=10, device="cpu"):
        return super().search(query, k, device)


@pytest.fixture(scope="module")
def high_df_corpus():
    from yams_tpu_torch.core.config import LexicalIndexConfig

    rng = np.random.default_rng(5)
    docs = {}
    for d in range(600):
        words = ["common"] * int(rng.integers(1, 20)) + ["filler"] * int(rng.integers(5, 40))
        if d % 50 == 0:
            words += ["rareterm"]
        rng.shuffle(words)
        docs[d] = " ".join(words)
    docs[0] = " ".join(["common"] * 30 + ["rareterm"])
    idx = _CpuLexical(LexicalIndexConfig(postings_window=contract.WINDOW, title_weight=0.0,
                                         content_weight=1.0))
    for d, text in docs.items():
        idx.add_document(d, text)
    return idx, docs


class TestPortWindowContract(contract.TestWindowContract):
    """The reference's postings-window contract (C1-C3) on the port's
    index, with the reference's fixture corpus."""
