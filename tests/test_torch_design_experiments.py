"""Port parity: the six design experiments (yams_tpu_torch/scripts/).

In the reference (scripts/profile_vec.py, exp_coarse_bf16.py,
exp_recall_target.py, profile_bm25.py, profile_bm25b.py,
profile_lex_stages.py) each variant is a closure inside `main()` that cannot
be called, so each JAX expression is written out below, under the file:line
it copies, and fed the same seeded NumPy inputs as the port's function.
Where the reference calls a package function, so does the test
(`yams_tpu.ops.bm25.bm25_topk_candidates`, `yams_tpu.ops.scan.dense_scores`
and `grouped_topk_pallas(..., interpret=True)`, as tests/test_ops.py runs
it). lax.approx_max_k is exact off the TPU, so the reference's approximate
rows compute on the CPU what the port's exact rows compute.

Tolerances:
- rows on f32 products of bf16 operands: ids equal, values within 1e-5
  (the sums run in another order);
- rows on bf16 scores: values within one bf16 ulp of the largest, and an id
  may differ only at a bf16 near-tie (chip_smoke.fused_agree's rule at one
  ulp: the two scores of the id within that ulp);
- the K1 sweep: ids equal and values within 1e-5 of grouped_topk_pallas at
  each group width;
- packed keys, sorts, gathers and profile_lex_stages' segment totals:
  bit-equal. The batched select.prefix_sum equals the vmap'd jnp.cumsum of
  each query bit for bit (held below). The packed candidates' sums are
  not bit-equal: the reference's XLA program recomputes the prefix sum
  inside a second fusion for the segment bases, so a doc's sum there sits
  a few f32 ulps of the query's total impact mass away from the port's.
  They are held to 1e-6 plus 8 such ulps, the gap tests/test_torch_bm25.py
  holds the packed path to, and an id may differ only where the two sums
  lie within that gap (a near-tie, by fused_agree's rule). Production's
  CSR candidates (bm25_topk_candidates) are held to ids equal and 1e-6, as
  tests/test_torch_bm25.py holds them;
- the overlap, recall, target and relative-error numbers each `measure`
  returns equal those of the JAX expressions on the same inputs, where the
  two sides pick the same ids. On bf16 scores exact ties are common, and
  approx_max_k on the CPU orders tied values as its sort leaves them (it
  compares values alone), where the port keeps lax.top_k's order (the
  lower row first): a tie across the 10th rank then picks another row, and
  the number may differ by the share of such ids, no more.

Each `run()` at a tiny size prints every row the reference prints, or its
named replacement.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from yams_tpu.ops import bm25 as ref_bm25
from yams_tpu.ops import scan as ref_scan
from yams_tpu_torch.scripts import (exp_coarse_bf16, exp_recall_target, profile_bm25,
                                    profile_bm25b, profile_lex_stages, profile_vec)
from yams_tpu_torch.ops.select import prefix_sum
from yams_tpu_torch.scripts._common import recall

CPU = torch.device("cpu")
bf16 = jnp.bfloat16


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _bf16_round(x):
    return np.asarray(jnp.asarray(x, bf16).astype(jnp.float32))


def _assert_bf16_agree(what, port, ref):
    """Values within one bf16 ulp of the largest; differing ids at near-ties."""
    pv, pi = (np.asarray(x) for x in port)
    rv, ri = (np.asarray(x) for x in ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(rv).max())) - 7)
    chip_smoke.fused_agree(what, _t(pv.astype(np.float32)), _t(pi), _t(rv.astype(np.float32)),
                           _t(ri), tol=ulp, tie=ulp)


def _assert_recall_matches(got, port_ids, ref_ids, port_oracle, ref_oracle):
    """A number `measure` returned is the port's own recall, and within the
    share of ids the two sides pick apart of the JAX expressions' recall
    (0 where they pick the same ids: equal then)."""
    assert got == recall(port_ids, port_oracle)
    apart = sum(len(set(a) - set(b)) for a, b in zip(port_ids, ref_ids))
    apart += sum(len(set(a) - set(b)) for a, b in zip(port_oracle, ref_oracle))
    assert abs(got - recall(ref_ids, ref_oracle)) <= apart / ref_ids.size + 1e-12


def _assert_f32_agree(port, ref):
    np.testing.assert_array_equal(np.asarray(port[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(np.asarray(port[0]), np.asarray(ref[0]), atol=1e-5, rtol=0)


# -- profile_vec ----------------------------------------------------------------
VN, VD, VB, VITERS, VD0 = 4096, 64, 8, 2, 16


@functools.lru_cache(maxsize=None)
def _vec_inputs():
    rng = np.random.default_rng(0)
    E = _bf16_round(_unit(rng.standard_normal((VN, VD))))
    Q = _unit(rng.standard_normal((VITERS, VB, VD)))
    return E, Q


def _ref_vec(q, E, name):
    """scripts/profile_vec.py's closures for one batch q."""
    C, RERANK, D0 = profile_vec.C, profile_vec.RERANK, VD0
    q, E = jnp.asarray(q), jnp.asarray(E, bf16)
    if name == "exact_topk":                                              # :104-105
        s = jnp.dot(q.astype(bf16), E.T, preferred_element_type=jnp.float32)
        return jax.lax.top_k(s, 10)
    if name == "base_f32_exact":                                          # :61-63
        s = jnp.dot(q.astype(bf16), E.T, preferred_element_type=jnp.float32)
        v, i = jax.lax.approx_max_k(s, C)
        return v[:, :10], i[:, :10]
    if name == "scores_bf16_exact":                                       # :70-73
        s = jnp.dot(q.astype(bf16), E.T, preferred_element_type=bf16)
        v, i = jax.lax.approx_max_k(s.astype(jnp.float32), C)
        return v[:, :10], i[:, :10]
    E0 = jnp.asarray(E[:, :D0])                                           # :43
    q0 = q[:, :D0].astype(bf16)                                           # :81-96
    if name == "mat192_exact":
        s0 = jnp.dot(q0, E0.T, preferred_element_type=jnp.float32)
    else:
        s0 = jnp.dot(q0, E0.T, preferred_element_type=bf16).astype(jnp.float32)
    cv, ci = jax.lax.approx_max_k(s0, C * RERANK)
    cand = E[ci]
    full = jnp.einsum("bd,bcd->bc", q.astype(bf16), cand, preferred_element_type=jnp.float32)
    v, pos = jax.lax.top_k(full, C)
    i = jnp.take_along_axis(ci, pos, axis=1)
    return v[:, :10], i[:, :10]


@pytest.mark.parametrize("name", [name for name, _ in profile_vec.ROWS])
def test_profile_vec_rows(name):
    E, Q = _vec_inputs()
    fn = dict(profile_vec.ROWS)[name]
    Et = _t(E).to(torch.bfloat16)
    for q in Q:
        port = [x.numpy() for x in fn(_t(q), Et, Et[:, :VD0].contiguous())]
        ref = _ref_vec(q, E, name)
        if "bf16" in name:
            _assert_bf16_agree(name, port, ref)
        else:
            _assert_f32_agree(port, ref)


def test_profile_vec_measure_overlaps_equal_the_references(capsys):
    E, Q = _vec_inputs()
    Et = _t(E).to(torch.bfloat16)
    out = profile_vec.measure(_t(Q), Et, Et[:, :VD0].contiguous(), CPU)
    port = {name: np.concatenate([fn(_t(q), Et, Et[:, :VD0].contiguous())[1].numpy()
                                  for q in Q]) for name, fn in profile_vec.ROWS}
    ref = {name: np.concatenate([np.asarray(_ref_vec(q, E, name)[1]) for q in Q])
           for name, _ in profile_vec.ROWS}
    for name, _ in profile_vec.ROWS[1:]:
        _assert_recall_matches(out["overlap"][name], port[name], ref[name],
                               port["exact_topk"], ref["exact_topk"])
    assert out["overlap"]["base_f32_exact"] == 1.0
    text = capsys.readouterr().out
    for name, _ in profile_vec.ROWS:
        assert f"{name} " in text
    assert "approx_max_k has no PyTorch counterpart" in text and "overlap vs exact: base=" in text


# -- exp_coarse_bf16 and exp_recall_target ----------------------------------------
CN, CD, CB, CITERS, CC = 8192, 64, 8, 2, 32


@functools.lru_cache(maxsize=None)
def _clustered(N=CN, D=CD):
    """bench.py's clustered corpus in NumPy: assignment hashed with a
    uint32 wrap, bf16 noise, rows renormalized in f32 and rounded to bf16."""
    rng = np.random.default_rng(1)
    centers = _unit(rng.standard_normal((64, D)))
    ar = np.arange(N, dtype=np.uint32)
    assign = ((ar * np.uint32(2654435761)) >> np.uint32(7)) % np.uint32(64)
    e = _bf16_round(_bf16_round(centers[assign]) + 0.35 * _bf16_round(rng.standard_normal((N, D))))
    E = _bf16_round(_unit(e))
    qs = _unit(rng.standard_normal((CITERS, CB, D)))
    return E, qs


def _ref_coarse(q, E, mode, cc):
    """scripts/exp_coarse_bf16.py:53-83, one batch."""
    C, K = CC, exp_coarse_bf16.K
    q, E = jnp.asarray(q), jnp.asarray(E, bf16)
    if mode == "f32":
        s = jnp.dot(q.astype(bf16), E.T, preferred_element_type=jnp.float32)
        vv, vi = jax.lax.approx_max_k(s, cc)
        vv, vi = vv[:, :C], vi[:, :C]
    elif mode == "bf16nr":
        s = jnp.dot(q.astype(bf16), E.T, preferred_element_type=bf16)
        vv, vi = jax.lax.approx_max_k(s, cc)
        vv = vv[:, :C].astype(jnp.float32)
        vi = vi[:, :C]
    elif mode == "bf16":
        s = jnp.dot(q.astype(bf16), E.T, preferred_element_type=bf16)
        _, ci = jax.lax.approx_max_k(s, cc)
        cand = E[ci]
        rs = jnp.einsum("bd,bcd->bc", q.astype(bf16), cand, preferred_element_type=jnp.float32)
        vv, pos = jax.lax.top_k(rs, C)
        vi = jnp.take_along_axis(ci, pos, axis=1)
    else:
        s = jnp.dot(q.astype(bf16), E.T, preferred_element_type=jnp.float32)
        vv, vi = jax.lax.top_k(s, C)
    return vv[:, :K], vi[:, :K]


COARSE = [("f32", CC), ("exact", CC), ("bf16nr", CC), ("bf16", CC), ("bf16", 4 * CC)]


@pytest.mark.parametrize("mode,cc", COARSE, ids=[f"{m}-{c}" for m, c in COARSE])
def test_exp_coarse_bf16_modes(mode, cc):
    E, qs = _clustered()
    Et = _t(E).to(torch.bfloat16)
    for q in qs:
        port = [x.numpy() for x in exp_coarse_bf16.coarse(_t(q), Et, mode, CC, cc)]
        ref = _ref_coarse(q, E, mode, cc)
        if mode == "bf16nr":
            _assert_bf16_agree(mode, port, ref)
        else:     # f32 products; bf16 rescores its candidates in f32
            _assert_f32_agree(port, ref)


def test_exp_coarse_bf16_measure_recalls_equal_the_references(capsys):
    E, qs = _clustered()
    Et = _t(E).to(torch.bfloat16)
    out = exp_coarse_bf16.measure(_t(qs), Et, CPU, CC)
    port = {(m, c): np.concatenate([exp_coarse_bf16.coarse(_t(q), Et, m, CC, c)[1].numpy()
                                    for q in qs]) for m, c in COARSE}
    ref = {(m, c): np.concatenate([np.asarray(_ref_coarse(q, E, m, c)[1]) for q in qs])
           for m, c in COARSE}
    oracle = ("exact", CC)
    for key, row in ((("f32", CC), "f32"), (oracle, "exact"), (("bf16nr", CC), "bf16nr"),
                     (("bf16", CC), f"bf16_C{CC}"), (("bf16", 4 * CC), f"bf16_C{4 * CC}")):
        _assert_recall_matches(out["rows"][row]["recall10"], port[key], ref[key],
                               port[oracle], ref[oracle])
    assert out["rows"]["f32"]["recall10"] == out["rows"]["exact"]["recall10"] == 1.0
    text = capsys.readouterr().out
    for head in ("f32  coarse C=  32", "bf16 norescore C=32", "bf16 coarse C=  32",
                 "bf16 coarse C= 128"):
        assert head in text
    assert text.count("[exact top-C]") == 4


RN_LIVE, RD = 32768 - 100, 32


def _recall_inputs():
    """exp_recall_target's layout: the live rows padded to K1's 2,048-row
    multiple with zero rows, valid 0 on the pad."""
    E, qs = _clustered(32768, RD)
    E = E.copy()
    E[RN_LIVE:] = 0.0
    valid = np.ones(32768, np.float32)
    valid[RN_LIVE:] = 0.0
    return E, valid, qs


def _ref_leg(q, E, valid, group):
    """The oracle (exp_recall_target.py:55-56, lax.top_k over dense_scores,
    the pad rows masked) or K1 (the reference's grouped_topk_pallas, in
    interpret mode)."""
    if group is None:
        return jax.lax.top_k(ref_scan.dense_scores(jnp.asarray(q), jnp.asarray(E, bf16),
                                                   jnp.asarray(valid)), CC)
    return ref_scan.grouped_topk_pallas(jnp.asarray(q), jnp.asarray(E, bf16), jnp.asarray(valid),
                                        CC, block_rows=exp_recall_target.BLOCK, group=group,
                                        interpret=True)


@pytest.mark.parametrize("group", [None, *exp_recall_target.GROUPS])
def test_exp_recall_target_sweep_rows(group):
    from yams_tpu_torch.ops.scan import dense_scores, grouped_topk_pallas
    from yams_tpu_torch.ops.select import top_k

    E, valid, qs = _recall_inputs()
    Et = _t(E).to(torch.bfloat16)
    for q in qs:
        if group is None:
            port = top_k(dense_scores(_t(q), Et, _t(valid)), CC)
        else:
            port = grouped_topk_pallas(_t(q), Et, _t(valid), CC,
                                       block_rows=exp_recall_target.BLOCK, group=group)
        _assert_f32_agree([x.numpy() for x in port], _ref_leg(q, E, valid, group))
        np.testing.assert_array_equal(
            exp_recall_target.leg(_t(q), Et, _t(valid), CC, group).numpy(), port[1][:, :10])


def test_exp_recall_target_measure_recalls_and_targets_equal_the_references(capsys):
    E, valid, qs = _recall_inputs()
    out = exp_recall_target.measure(_t(qs), _t(E).to(torch.bfloat16), _t(valid), CPU, CC)
    ids = {g: np.concatenate([np.asarray(_ref_leg(q, E, valid, g)[1])[:, :10] for q in qs])
           for g in (None, *exp_recall_target.GROUPS)}
    assert out["rows"]["exact"]["recall10"] == 1.0
    want = {g: recall(ids[g], ids[None]) for g in exp_recall_target.GROUPS}
    assert {g: out["rows"][f"k1_group{g}"]["recall10"] for g in want} == want
    for rt in exp_recall_target.TARGETS:
        met = [g for g, r in want.items() if r >= rt]
        assert out["targets"][rt] == (max(met) if met else None)
    text = capsys.readouterr().out
    assert "exact (dot_f32 + top-C, the oracle)" in text
    assert all(f"K1 group={g:5d}" in text for g in exp_recall_target.GROUPS)
    assert all(f"recall_target={rt:4.2f}: " in text for rt in exp_recall_target.TARGETS)


def test_contract_recall_counts_the_ids_a_group_keeps():
    oracle = np.array([[0, 1, 40, 7, 63], [64, 200, 130, 129, 5]])
    # group 64: query 0 keeps 0 and loses 1, 40, 7, 63 to 0; query 1 keeps
    # 64, 200, 130 and 5 and loses 129 to 130
    assert exp_recall_target.contract_recall(oracle, 64) == 5 / 10
    assert exp_recall_target.contract_recall(oracle, 1) == 1.0


def test_exp_recall_target_k1_recall_is_its_contracts(capsys):
    """The reference's K1 (interpret mode) loses exactly the oracle ids its
    contract gives up, and `measure` reports that contract beside the
    port's recall, which equals it here (the CPU twin scores with the
    oracle's own sums)."""
    E, valid, qs = _recall_inputs()
    out = exp_recall_target.measure(_t(qs), _t(E).to(torch.bfloat16), _t(valid), CPU, CC)
    ids = {g: np.concatenate([np.asarray(_ref_leg(q, E, valid, g)[1])[:, :10] for q in qs])
           for g in (None, *exp_recall_target.GROUPS)}
    for g in exp_recall_target.GROUPS:
        row = out["rows"][f"k1_group{g}"]
        want = exp_recall_target.contract_recall(ids[None], g)
        assert recall(ids[g], ids[None]) == want
        assert row["contract_recall10"] == row["recall10"] == want
    assert "its contract allows" in capsys.readouterr().out


# -- profile_bm25 and profile_bm25b ---------------------------------------------
BN, BV, BW, BT, BB, BITERS = 4096, 128, 64, 4, 8, 2


@functools.lru_cache(maxsize=None)
def _bm25_inputs():
    """profile_bm25.py:37-47 at a tiny size (the uint32 hashes in JAX)."""
    per_term = BW // 2
    ar = jnp.arange(BV * per_term, dtype=jnp.uint32)
    pd = ((ar * jnp.uint32(2654435761)) % jnp.uint32(BN)).astype(jnp.int32)
    pd = jnp.concatenate([pd, jnp.full((BW,), BN, jnp.int32)])
    pi = ((ar * jnp.uint32(40503)) % jnp.uint32(190)).astype(jnp.float32) / 40.0 + 0.5
    pi = jnp.concatenate([pi, jnp.zeros(BW)])
    to = jnp.arange(BV, dtype=jnp.int32) * per_term
    tl = jnp.full(BV, per_term, jnp.int32)
    rng = np.random.default_rng(2)
    tids = rng.integers(0, BV, (BITERS, BB, BT)).astype(np.int32)
    tmask = np.ones((BITERS, BB, BT), np.float32)
    tmask[0, 1, 2] = 0.0     # a masked term takes the sink
    return tuple(np.asarray(x) for x in (pd, pi, to, tl)), tids, tmask


def _ref_gather(tids, tmask, pd, pi, to, tl):
    """profile_bm25.py:60-71 (one query)."""
    def gather_term(tid, m):
        off = jnp.clip(to[tid], 0, pd.shape[0] - BW)
        docs = jax.lax.dynamic_slice(pd, (off,), (BW,))
        imp = jax.lax.dynamic_slice(pi, (off,), (BW,))
        pos = jax.lax.broadcasted_iota(jnp.int32, (BW, 1), 0)[:, 0]
        pmask = (pos < tl[tid]) & (m > 0)
        return jnp.where(pmask, docs, BN), jnp.where(pmask, imp, 0.0)

    docs, contrib = jax.vmap(gather_term)(tids, tmask)
    return docs.reshape(-1), contrib.reshape(-1)


QBITS = 31 - int(np.ceil(np.log2(BN + 2)))
QMAX = (1 << QBITS) - 1


def _ref_segments(keys, vmax):
    """profile_bm25.py:100-114 / profile_bm25b.py:121-130 after the keys
    (one query): -> (ids, per-doc sums) of the top-C."""
    keys = jax.lax.sort(keys)
    ids = keys >> QBITS
    val = (keys & QMAX).astype(jnp.float32) * (vmax / QMAX)
    cs = jnp.cumsum(val)
    first = jnp.concatenate([jnp.ones(1, bool), ids[1:] != ids[:-1]])
    last = jnp.concatenate([ids[1:] != ids[:-1], jnp.ones(1, bool)])
    base = jax.lax.cummax(jnp.where(first, cs - val, -jnp.inf))
    seg_total = jnp.where(last & (ids < BN), cs - base, 0.0)
    c_scores, c_pos = jax.lax.top_k(seg_total, profile_bm25.C)
    return jnp.where(c_scores > 0, ids[c_pos], BN), c_scores


@jax.jit
def _ref_packed1(tids, tmask, pd, pi, to, tl):
    """profile_bm25.py:95-114, use_axk False (approx_max_k is exact here)."""
    def packed_q(t, m):
        ids, val = _ref_gather(t, m, pd, pi, to, tl)
        vmax = 5.5
        quant = jnp.clip(jnp.round(val * (QMAX / vmax)), 0, QMAX).astype(jnp.int32)
        return _ref_segments((ids << QBITS) | quant, vmax)
    return jax.vmap(packed_q)(tids, tmask)


def _packed_gap(keys):
    """1e-6 + 8 f32 ulps of each query's total dequantized impact mass,
    (B, T, W) packed keys -> the largest over the batch."""
    mass = ((np.asarray(keys) & QMAX) * (5.5 / QMAX)).reshape(len(keys), -1).sum(axis=1)
    return float((1e-6 + 8 * np.spacing(mass.astype(np.float32))).max())


def _batches_gap(postings, tids, tmask):
    """_packed_gap over every batch's packed keys."""
    pt = [_t(p) for p in postings]
    return max(_packed_gap(profile_bm25.quantize_keys(
        *profile_bm25.gather(_t(t), _t(m), *pt, BW, BN), QBITS, 5.5).numpy())
        for t, m in zip(tids, tmask))


def _assert_packed_agree(what, ids, sums, want, gap):
    chip_smoke.fused_agree(what, sums, ids, _t(want[1]), _t(want[0]), tol=gap, tie=gap)


def _ref_sort2(tids, tmask, postings):
    return ref_bm25.bm25_topk_candidates(jnp.asarray(tids), jnp.asarray(tmask), *postings,
                                         window=BW, num_docs=BN,
                                         num_candidates=profile_bm25.C)


def test_profile_bm25_postings_are_the_references():
    postings, _, _ = _bm25_inputs()
    for got, want in zip(profile_bm25.hashed_postings(BN, BV, BW, CPU), postings):
        np.testing.assert_array_equal(got.numpy(), want)


def test_profile_bm25_gather_and_packed_keys_are_bit_equal():
    postings, tids, tmask = _bm25_inputs()
    pt = [_t(p) for p in postings]
    qbits = profile_bm25.packed_qbits(BN)
    assert qbits == QBITS
    for t, m in zip(tids, tmask):
        docs, val = profile_bm25.gather(_t(t), _t(m), *pt, BW, BN)
        want = jax.vmap(lambda a, b: _ref_gather(a, b, *map(jnp.asarray, postings)))(t, m)
        np.testing.assert_array_equal(docs.reshape(BB, -1).numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(val.reshape(BB, -1).numpy(), np.asarray(want[1]))
        keys = profile_bm25.quantize_keys(docs, val, qbits, profile_bm25.VMAX)
        quant = jnp.clip(jnp.round(want[1] * (QMAX / 5.5)), 0, QMAX).astype(jnp.int32)
        np.testing.assert_array_equal(keys.reshape(BB, -1).numpy(),
                                      np.asarray((want[0] << QBITS) | quant))


def test_profile_bm25_rows_equal_the_references():
    postings, tids, tmask = _bm25_inputs()
    pt = [_t(p) for p in postings]
    qbits = profile_bm25.packed_qbits(BN)
    for t, m in zip(tids, tmask):
        docs, val = profile_bm25.gather(_t(t), _t(m), *pt, BW, BN)
        keys = profile_bm25.quantize_keys(docs, val, qbits, profile_bm25.VMAX)
        ids, sums = profile_bm25.packed_candidates(keys, BN, profile_bm25.C, qbits,
                                                   profile_bm25.VMAX)
        _assert_packed_agree("packed1", ids, sums, _ref_packed1(t, m, *postings),
                             _packed_gap(keys))
        from yams_tpu_torch.ops.bm25 import bm25_topk_candidates
        got = bm25_topk_candidates(_t(t), _t(m), *pt, window=BW, num_docs=BN,
                                   num_candidates=profile_bm25.C)
        want = _ref_sort2(t, m, postings)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)


def test_prefix_sum_of_packed_impacts_is_the_vmapped_cumsum():
    """The gap above is the fusion's, not prefix_sum's: over each query's
    sorted, dequantized keys prefix_sum equals vmap(jnp.cumsum) bit for bit."""
    postings, tids, tmask = _bm25_inputs()
    pt = [_t(p) for p in postings]
    for t, m in zip(tids, tmask):
        docs, val = profile_bm25.gather(_t(t), _t(m), *pt, BW, BN)
        keys = profile_bm25.quantize_keys(docs, val, QBITS, 5.5).reshape(BB, -1)
        val = (keys.sort(dim=1).values & QMAX).float() * (5.5 / QMAX)
        want = jax.jit(jax.vmap(jnp.cumsum))(jnp.asarray(val.numpy()))
        np.testing.assert_array_equal(prefix_sum(val).numpy(), np.asarray(want))


def _ref_rel_err(r1, r2):
    """profile_bm25.py:132 / profile_bm25b.py:157."""
    return np.abs(r1 - r2).max() / max(np.abs(r2).max(), 1e-9)


def test_profile_bm25_measure_rel_err_equals_the_references(capsys):
    postings, tids, tmask = _bm25_inputs()
    out = profile_bm25.measure(_t(tids), _t(tmask), *[_t(p) for p in postings], N=BN,
                               device=CPU, window=BW)
    r1 = np.concatenate([np.asarray(_ref_packed1(t, m, *postings)[1][:, 0])
                         for t, m in zip(tids, tmask)])
    r2 = np.concatenate([np.asarray(_ref_sort2(t, m, postings)[1][:, 0])
                         for t, m in zip(tids, tmask)])
    np.testing.assert_allclose(out["rel_err"], _ref_rel_err(r1, r2), rtol=0,
                               atol=(_batches_gap(postings, tids, tmask) + 1e-6)
                               / np.abs(r2).max())
    text = capsys.readouterr().out
    for name in ("gather_only", "sort2", "packed1", "packed1_axk_exact"):
        assert f"{name} " in text
    assert "approx_max_k has no PyTorch counterpart" in text
    assert "packed vs exact top1 rel err: " in text


@jax.jit
def _ref_build_2d(pd1, pi1, to, tl):
    """profile_bm25b.py:52-62."""
    idx = to[:, None] + jnp.arange(BW)[None, :]
    ok = jnp.arange(BW)[None, :] < tl[:, None]
    idx = jnp.clip(idx, 0, pd1.shape[0] - 1)
    d2 = jnp.where(ok, pd1[idx], BN)
    i2 = jnp.where(ok, pi1[idx], 0.0)
    q = jnp.clip(jnp.round(i2 * (QMAX / 5.5)), 0, QMAX).astype(jnp.int32)
    pk = jnp.where(ok, (d2 << QBITS) | q, (BN << QBITS))
    return d2, i2, pk


@jax.jit
def _ref_bm25b_rows(tids, tmask, pd1, pi1, to, tl, d2, i2, pk):
    """profile_bm25b.py:79-135 for one batch: slice_csr, dense2d,
    dense2d_pk and full_packed's (ids, sums)."""
    d, v = jax.vmap(lambda a, b: _ref_gather(a, b, pd1, pi1, to, tl))(tids, tmask)
    slice_csr = (v.sum(1), d.max(1))
    dd = d2[tids]
    vv = i2[tids] * tmask[..., None]
    dense2d = (vv.sum((1, 2)), dd.max((1, 2)))
    k = jnp.where(tmask[..., None] > 0, pk[tids], (BN << QBITS))
    dense2d_pk = (k.max((1, 2)), k.min((1, 2)))
    full = jax.vmap(lambda kk: _ref_segments(kk.reshape(-1), 5.5))(k)
    return slice_csr, dense2d, dense2d_pk, full


def test_profile_bm25b_views_and_rows_equal_the_references():
    postings, tids, tmask = _bm25_inputs()
    pt = [_t(p) for p in postings]
    views = profile_bm25b.build_2d(*pt, BW, BN)
    want_views = _ref_build_2d(*postings)
    for got, want in zip(views, want_views):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d2, i2, pk = views
    qbits = profile_bm25.packed_qbits(BN)
    for t, m in zip(tids, tmask):
        slice_csr, dense2d, dense2d_pk, full = _ref_bm25b_rows(t, m, *postings, *want_views)
        d, v = profile_bm25.gather(_t(t), _t(m), *pt, BW, BN)
        np.testing.assert_array_equal(d.amax(dim=(1, 2)).numpy(), np.asarray(slice_csr[1]))
        np.testing.assert_allclose(v.sum(dim=(1, 2)).numpy(), np.asarray(slice_csr[0]),
                                   rtol=1e-6)
        tl_ = _t(t).long()
        np.testing.assert_array_equal(d2[tl_].amax(dim=(1, 2)).numpy(), np.asarray(dense2d[1]))
        keys = torch.where(_t(m)[:, :, None] > 0, pk[tl_], BN << qbits)
        np.testing.assert_array_equal(keys.amax(dim=(1, 2)).numpy(), np.asarray(dense2d_pk[0]))
        np.testing.assert_array_equal(keys.amin(dim=(1, 2)).numpy(), np.asarray(dense2d_pk[1]))
        ids, sums = profile_bm25.packed_candidates(keys, BN, profile_bm25.C, qbits,
                                                   profile_bm25.VMAX)
        _assert_packed_agree("full_packed", ids, sums, full, _packed_gap(keys))


def test_profile_bm25b_measure_rel_err_equals_the_references(capsys):
    postings, tids, tmask = _bm25_inputs()
    out = profile_bm25b.measure(_t(tids), _t(tmask), *[_t(p) for p in postings], N=BN,
                                device=CPU, window=BW)
    views = _ref_build_2d(*postings)
    r = np.concatenate([np.asarray(_ref_bm25b_rows(t, m, *postings, *views)[3][1][:, 0])
                        for t, m in zip(tids, tmask)])
    r2 = np.concatenate([np.asarray(_ref_sort2(t, m, postings)[1][:, 0])
                         for t, m in zip(tids, tmask)])
    np.testing.assert_allclose(out["rel_err"], _ref_rel_err(r, r2), rtol=0,
                               atol=(_batches_gap(postings, tids, tmask) + 1e-6)
                               / np.abs(r2).max())
    text = capsys.readouterr().out
    for name in ("slice_csr", "dense2d", "dense2d_pk", "full_packed"):
        assert f"{name} " in text
    assert "full_packed vs production top1 rel err: " in text


# -- profile_lex_stages -----------------------------------------------------------
LB, LT, LW, LV, LQ = 8, 4, 64, 256, 11


def _ref_seg(packed, tids):
    """profile_lex_stages.py:40-50."""
    keys = jax.lax.sort(packed[tids].reshape(LB, LT * LW), dimension=1)
    ids = keys >> LQ
    val = (keys & ((1 << LQ) - 1)).astype(jnp.float32)
    cs = jnp.cumsum(val, axis=1)
    first = jnp.concatenate([jnp.ones((LB, 1), bool), ids[:, 1:] != ids[:, :-1]], axis=1)
    last = jnp.concatenate([ids[:, 1:] != ids[:, :-1], jnp.ones((LB, 1), bool)], axis=1)
    base = jax.lax.cummax(jnp.where(first, cs - val, -jnp.inf), axis=1)
    return jnp.where(last, cs - base, 0.0), ids


def test_profile_lex_stages_equal_the_references():
    rng = np.random.default_rng(3)
    packed = (rng.integers(-(1 << 31), (1 << 31) - 1, (LV, LW), dtype=np.int64)
              .astype(np.int32) >> 1)
    assert (packed < 0).any()          # the arithmetic shift keeps negative keys
    tids = rng.integers(0, LV, (LB, LT)).astype(np.int32)
    stages = dict(profile_lex_stages.stages(_t(packed), _t(tids), LQ))
    P, Tj = jnp.asarray(packed), jnp.asarray(tids)

    def wrap32(x):        # jnp.sum of int32 wraps at 2**32; torch's sum is int64
        return x.numpy().astype(np.int64).astype(np.int32)

    np.testing.assert_array_equal(wrap32(stages["gather"]()),                   # :32
                                  np.asarray(jnp.sum(P[Tj].reshape(LB, LT * LW), axis=1)))
    np.testing.assert_array_equal(wrap32(stages["gather+sort"]()), np.asarray(    # :37
        jnp.sum(jax.lax.sort(P[Tj].reshape(LB, LT * LW), dimension=1), axis=1)))
    seg, ids = profile_lex_stages.segments(_t(packed), _t(tids), LQ)
    want_seg, want_ids = _ref_seg(P, Tj)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(want_seg))           # bit-equal
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    s_sum, i_sum = stages["+segsum"]()
    np.testing.assert_array_equal(wrap32(i_sum), np.asarray(jnp.sum(want_ids, axis=1)))
    np.testing.assert_allclose(s_sum.numpy(), np.asarray(jnp.sum(want_seg, axis=1)), rtol=1e-6)
    v, p = jax.lax.top_k(want_seg, 32)                                          # :62-63
    for name in ("+topk(full)", "+approxk(full)_exact"):
        got_v, got_i = stages[name]()
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(jnp.take_along_axis(want_ids, p,
                                                                                      axis=1)))
    np.testing.assert_array_equal(wrap32(stages["persort1024"]()), np.asarray(     # :76
        jnp.sum(jax.lax.sort(P[Tj], dimension=2), axis=(1, 2))))


# -- each run() at a tiny size prints every row -------------------------------------
RUNS = {
    "profile_vec": (lambda: profile_vec.run(N=2048, D=32, B=4, iters=1, D0=8, device="cpu"),
                    ["exact_topk", "base_f32_exact", "scores_bf16_exact", "mat192_exact",
                     "mat192_bf16_exact", "overlap vs exact: "]),
    "exp_coarse_bf16": (lambda: exp_coarse_bf16.run(N=4096, D=32, B=4, iters=1, n_clusters=32,
                                                    device="cpu"),
                        ["f32  coarse C=", "bf16 norescore C=", "bf16 coarse C=  32",
                         "bf16 coarse C= 128"]),
    "exp_recall_target": (lambda: exp_recall_target.run(N=8192 - 10, D=32, B=4, iters=1,
                                                        n_clusters=32, groups=(16, 64),
                                                        device="cpu"),
                          ["exact (dot_f32", "K1 group=   16", "K1 group=   64",
                           "recall_target=0.99", "recall_target=0.80"]),
    "profile_bm25": (lambda: profile_bm25.run(N=4096, B=4, iters=1, T=4, vocab=64, window=64,
                                              device="cpu"),
                     ["gather_only", "sort2", "packed1 ", "packed1_axk_exact",
                      "packed vs exact top1 rel err"]),
    "profile_bm25b": (lambda: profile_bm25b.run(N=4096, B=4, iters=1, T=4, vocab=64, window=64,
                                                device="cpu"),
                      ["slice_csr", "dense2d ", "dense2d_pk", "full_packed ",
                       "full_packed vs production top1 rel err"]),
    "profile_lex_stages": (lambda: profile_lex_stages.run(B=4, T=4, W=64, V=128, reps=1,
                                                          device="cpu"),
                           ["gather ", "gather+sort", "+segsum", "+topk(full)",
                            "+approxk(full)_exact", "persort1024"]),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_run_prints_every_row(name, capsys):
    run, heads = RUNS[name]
    out = run()
    assert out["experiment"] == name and out["device"] == "cpu"
    text = capsys.readouterr().out
    for head in heads:
        assert head in text, head


# -- smoke phase 17's gates and checks, at the tiny sizes ----------------------------
PHASE17_TINY = {
    "profile_vec": dict(N=2048, D=32, B=4, iters=1, D0=8),
    "exp_coarse_bf16": dict(N=4096, D=32, B=4, iters=1, n_clusters=32),
    "exp_recall_target": dict(N=8192 - 10, D=32, B=4, iters=1, n_clusters=32, groups=(16, 64)),
    "profile_bm25": dict(N=4096, B=4, iters=1, T=4, vocab=64, window=64),
    "profile_bm25b": dict(N=4096, B=4, iters=1, T=4, vocab=64, window=64),
    "profile_lex_stages": dict(B=4, T=4, W=64, V=128, reps=1),
}


def test_phase17_gates_pass_on_the_cpu():
    out = chip_smoke.phase17_design_experiments(CPU, "cpu", PHASE17_TINY)
    assert set(PHASE17_TINY) <= set(out)
    for r in out["exp_recall_target"]["rows"].values():
        if "group" in r:
            assert r["recall10"] == r["contract_recall10"]


def test_phase17_dot_bf16_and_rescore_checks():
    qs, E, _ = exp_recall_target.make_inputs(4096 - 10, 32, 8, 1, 32, 0.35, CPU, 0)
    assert chip_smoke.phase17_dot_bf16(qs, E[:4096 - 10])["max_ulps"] <= 1.0
    out = chip_smoke.phase17_rescore(*profile_vec.make_inputs(2048, 32, 8, 1, 8, CPU, 0))
    assert set(out) == {"mat192", "mat192_bf16"}
    assert all(r["max_abs_err"] <= 1e-5 for r in out.values())


def test_phase17_dot_bf16_check_catches_a_product_off_by_two_ulps(monkeypatch):
    from yams_tpu_torch.scripts import _common

    def off(a, b_t, real=_common.dot_bf16):
        s = real(a, b_t).float()
        ulp = torch.exp2(torch.floor(torch.log2(s.abs().amax(dim=1))) - 7)
        return (s + 2 * ulp[:, None]).to(torch.bfloat16)

    monkeypatch.setattr(_common, "dot_bf16", off)
    qs, E, _ = exp_recall_target.make_inputs(4096 - 10, 32, 8, 1, 32, 0.35, CPU, 0)
    with pytest.raises(RuntimeError, match="dot_bf16"):
        chip_smoke.phase17_dot_bf16(qs, E)
