"""Port parity: the exact KNN scan and its block kernel K3, and the
grouped-max scan K1 (ops/scan.py).

Seeded NumPy corpora go through yams_tpu's dense_scores / exact_topk_scan /
exact_topk_pallas / grouped_topk_pallas (the Pallas kernels in interpret
mode on the CPU, as tests/test_ops.py runs them) and the port's, whose
block and group steps on a CPU tensor are the plain twins
`exact_topk_reference` and `grouped_max_reference`. Values agree to 1e-5
(f32 sums of bf16 products in another order); ids agree wherever the value
is above -1e29 except at near-ties (the two true scores within 1e-5), and
the -1e30 slots hold the TPU's rows: K3's repeated block start (hazard H2:
the knock-out value equals the masked score), K1's last row of a dead group
(its argmax takes the last lane among equal maxima). K1's result does not
depend on its block_rows (a layout on the TPU), so one twin is held against
the kernel at block_rows 1,024, 2,048 and 4,096.
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


# Edges of the CUDA kernel's design, held on the twin against the Pallas
# kernel: query tiles of 256 (B 255-257); the threshold epilogue (k <= 16)
# and the score dump (k > 16); ties on both sides of a 128-row tile edge and
# of a block edge; 24 exact ties inside one 128-row tile (more than the
# kernel's 20 slots a query); scores that rise with the row (every tile inserts); a
# dead block and k - 1 live rows at block_rows 64 and 192 (TMA's zeros past
# a block's end). Tolerances as above: values to 1e-5, live ids equal.
EDGE_D = 64


def _edge_inputs(case: str, k: int, bq: int, n: int, br: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    E = _unit(rng.standard_normal((n, EDGE_D)))
    q = _unit(rng.standard_normal((bq, EDGE_D)))
    valid = np.ones(n, np.float32)
    valid[rng.random(n) < 0.05] = 0.0
    if case == "tile_ties":         # copies of q[b] at rows 127/128, br-1/br, 383/384
        for b in range(bq):
            pair = ((127, 128), (br - 1, br), (383, 384))[b % 3]
            E[list(pair)] = q[b]
            valid[list(pair)] = 1.0
    elif case == "tile_dupes":      # q[b]'s 24 copies in one 128-row tile: more than 20 slots
        for b in range(bq):
            rows = _tile_dupe_rows(b, n)
            E[rows] = q[b]
            valid[rows] = 1.0
    elif case == "rising":          # row r of a block scores (r % br) / 2,048 exactly
        r = np.arange(n) % br
        E[:] = 0.0
        E[:, 0], E[:, 1] = (r // 16) / 128, (r % 16) / 16
        q[:] = 0.0
        q[:, 0], q[:, 1] = 1.0, 1.0 / 128
        valid[:] = 1.0
    elif case == "dead_block":
        valid[br:2 * br] = 0.0
    elif case == "k_minus_1_live":
        valid[br:2 * br] = 0.0
        valid[br + rng.choice(br, k - 1, replace=False)] = 1.0
    return q, E, valid


def _tile_dupe_rows(b: int, n: int) -> list[int]:
    """Every 5th row of 128-row tile b % (n / 128), from offset (b // (n /
    128)) % 5: 24 ascending rows, shared by no two of up to 5 n / 128 queries."""
    tiles = n // 128
    return [128 * (b % tiles) + (b // tiles) % 5 + 5 * i for i in range(24)]


def _ref_blocks_at(q, E, valid, k, br):
    """The reference's K3 block step at any (B, N, block_rows)."""
    (bq, dim), G = q.shape, E.shape[0] // br
    return pl.pallas_call(
        functools.partial(ref_scan._topk_block_kernel, k=k),
        grid=(G,),
        in_specs=[pl.BlockSpec((bq, dim), lambda i: (0, 0)),
                  pl.BlockSpec((br, dim), lambda i: (i, 0)),
                  pl.BlockSpec((br,), lambda i: (i,))],
        out_specs=(pl.BlockSpec((1, bq, k), lambda i: (i, 0, 0)),
                   pl.BlockSpec((1, bq, k), lambda i: (i, 0, 0))),
        out_shape=(jax.ShapeDtypeStruct((G, bq, k), jnp.float32),
                   jax.ShapeDtypeStruct((G, bq, k), jnp.int32)),
        interpret=True,
    )(jnp.asarray(q, jnp.bfloat16), jnp.asarray(E, jnp.bfloat16), jnp.asarray(valid))


K3_EDGES = [   # (case, k, B, N, block_rows)
    ("random", 10, 255, 1024, 512),
    ("random", 10, 256, 1024, 512),
    ("random", 16, 257, 1024, 512),
    ("random", 1, 3, 1024, 512),
    ("random", 17, 3, 1024, 512),
    ("random", 128, 3, 1024, 512),
    ("random", 129, 3, 1024, 512),
    ("tile_ties", 1, 3, 1024, 256),
    ("tile_ties", 10, 3, 1024, 256),
    ("tile_dupes", 10, 3, 1024, 512),
    ("tile_dupes", 16, 3, 1024, 512),
    ("tile_dupes", 17, 3, 1024, 512),
    ("tile_dupes", 16, 20, 1024, 256),
    ("rising", 10, 3, 1024, 256),
    ("rising", 129, 3, 1024, 256),
    ("dead_block", 10, 3, 512, 64),
    ("k_minus_1_live", 10, 3, 512, 64),
    ("dead_block", 16, 3, 768, 192),
    ("k_minus_1_live", 129, 3, 768, 192),
]


@pytest.mark.parametrize("case,k,bq,n,br", K3_EDGES)
def test_k3_block_twin_matches_pallas_interpret_at_kernel_edges(case, k, bq, n, br):
    q, E, valid = _edge_inputs(case, k, bq, n, br)
    want_v, want_i = _ref_blocks_at(q, E, valid, k, br)
    got_v, got_i = port_scan.exact_topk_reference(
        _t(q, torch.bfloat16), _t(E, torch.bfloat16), _t(valid), k, br)
    assert got_v.shape == (n // br, bq, k)
    _assert_topk_equal(got_v, got_i, want_v, want_i)
    dead = np.asarray(want_v) <= -1e29
    np.testing.assert_array_equal(got_i.numpy()[dead], np.asarray(want_i)[dead])
    if case == "tile_ties":         # the copy at the lower row ranks first
        for b in range(bq):
            lo = ((127, 128), (br - 1, br), (383, 384))[b % 3][0]
            g = lo // br
            assert got_i[g, b, 0] == lo
    if case == "tile_dupes":        # exact ties: the lowest rows, in row order
        for b in range(bq):
            rows = _tile_dupe_rows(b, n)
            assert got_i[rows[0] // br, b, :min(k, 24)].tolist() == rows[:k]
    if case == "rising":            # each block's top-k is its last k rows, highest first
        last = (np.arange(n // br)[:, None] + 1) * br - 1 - np.arange(k)[None, :]
        np.testing.assert_array_equal(got_i.numpy()[:, 0], last)
    if case in ("dead_block", "k_minus_1_live"):
        assert dead.any()


@pytest.mark.parametrize("br", [64, 192])
def test_k3_block_twin_at_k_equal_block_rows_matches_exact_scan(br):
    """k = block_rows: each block's whole ranking. Held per block against the
    port's exact_topk_scan of that block alone (its dead tail is (-1e30, -1);
    the block step's is (-1e30, block start)). Values to 1e-5, live ids equal."""
    n = 4 * br
    q, E, valid = _edge_inputs("k_minus_1_live", 5, 3, n, br)
    got_v, got_i = port_scan.exact_topk_reference(
        _t(q, torch.bfloat16), _t(E, torch.bfloat16), _t(valid), br, br)
    for g in range(n // br):
        sl = slice(g * br, (g + 1) * br)
        want_v, want_i = port_scan.exact_topk_scan(
            _t(q), _t(E[sl], torch.bfloat16), _t(valid[sl]), br, block_rows=br)
        live = want_v.numpy() > -1e29
        np.testing.assert_allclose(got_v[g].numpy(), want_v.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got_i[g].numpy()[live], want_i.numpy()[live] + g * br)
        assert (got_i[g].numpy()[~live] == g * br).all()


@pytest.mark.parametrize("n,want", [(1 << 20, 256), (1 << 26, 4), (1 << 30, 1), (4096, 65536)])
def test_dump_query_slice_bounds_the_score_buffer(n, want):
    """K3's score dump (k > 16) takes queries in slices whose N x b f32
    scores stay within 1 GiB, at least one query a slice."""
    got = port_scan.dump_query_slice(n)
    assert got == want
    assert got == 1 or 4 * n * got <= port_scan._DUMP_BYTES


def test_exact_topk_cuda_refuses_misaligned_queries():
    q, E, valid = _inputs("random", 10)
    qq = _misaligned(_t(q, torch.bfloat16), 1)
    with pytest.raises(ValueError, match="16-byte"):
        port_scan.exact_topk_cuda(qq, _t(E, torch.bfloat16), _t(valid), 10, BR)


# -- K1: per-group max / last argmax, and grouped_topk_pallas -------------------
GN = 8192
GROUPS = (64, 128, 256)
BLOCKS = (1024, 2048, 4096)
K1_CASES = ("random", "dead_group", "duplicates", "last_lane_tie")


def _k1_inputs(case: str, seed: int = 1, dim: int = D):
    rng = np.random.default_rng(seed)
    E = _unit(rng.standard_normal((GN, dim)))
    q = _unit(rng.standard_normal((B, dim)))
    valid = np.ones(GN, np.float32)
    valid[rng.random(GN) < 0.05] = 0.0
    if case == "dead_group":        # whole groups with no live row, at every group size
        valid[1024:2048] = 0.0
    elif case == "duplicates":      # two copies of q[b] in one group: the later wins
        for b in range(B):
            E[[11 + b, 40 + b, 3000 + b]] = q[b]
            valid[[11 + b, 40 + b, 3000 + b]] = 1.0
    elif case == "last_lane_tie":   # every row of a 256-row run equal: the group's last wins
        E[2048:2304] = E[2048]
        valid[2048:2304] = 1.0
    return q, E, valid


def _ref_groups(q, E, valid, group, block_rows):
    """The reference's K1 step alone, transposed to (B, N/group)."""
    G, nsub, dim = GN // block_rows, block_rows // group, q.shape[1]
    v, i = pl.pallas_call(
        functools.partial(ref_scan._grouped_max_kernel, group=group),
        grid=(G,),
        in_specs=[pl.BlockSpec((B, dim), lambda g: (0, 0)),
                  pl.BlockSpec((block_rows, dim), lambda g: (g, 0)),
                  pl.BlockSpec((block_rows,), lambda g: (g,))],
        out_specs=(pl.BlockSpec((1, B, nsub), lambda g: (g, 0, 0)),
                   pl.BlockSpec((1, B, nsub), lambda g: (g, 0, 0))),
        out_shape=(jax.ShapeDtypeStruct((G, B, nsub), jnp.float32),
                   jax.ShapeDtypeStruct((G, B, nsub), jnp.int32)),
        interpret=True,
    )(jnp.asarray(q, jnp.bfloat16), jnp.asarray(E, jnp.bfloat16), jnp.asarray(valid))
    return (np.asarray(v).transpose(1, 0, 2).reshape(B, -1),
            np.asarray(i).transpose(1, 0, 2).reshape(B, -1))


def _assert_same_winners(got_v, got_i, want_v, want_i, q, E, valid):
    """Values to 1e-5; ids equal, except a live id whose true (f64) score is
    within 1e-5 of the reference's id's (a near-tie)."""
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    np.testing.assert_allclose(got_v, want_v, atol=1e-5, rtol=0)
    diff = got_i != want_i
    assert not (diff & (want_v <= -1e29)).any(), "dead slots must match exactly"
    qb = np.asarray(jnp.asarray(q, jnp.bfloat16), np.float64)
    eb = np.asarray(jnp.asarray(E, jnp.bfloat16), np.float64)
    for b, c in zip(*np.nonzero(diff)):
        s_got, s_want = qb[b] @ eb[got_i[b, c]], qb[b] @ eb[want_i[b, c]]
        assert abs(s_got - s_want) <= 1e-5 and valid[got_i[b, c]] > 0, (b, c)


@pytest.mark.parametrize("block_rows", BLOCKS)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_group_twin_matches_pallas_interpret(case, group, block_rows):
    q, E, valid = _k1_inputs(case)
    want_v, want_i = _ref_groups(q, E, valid, group, block_rows)
    got_v, got_i = port_scan.grouped_max_reference(
        _t(q, torch.bfloat16), _t(E, torch.bfloat16), _t(valid), group)
    _assert_same_winners(got_v, got_i, want_v, want_i, q, E, valid)
    dead = want_v <= -1e29
    if case == "dead_group":        # (-1e30, the group's last row)
        cols = np.arange(1024 // group, 2048 // group)
        assert dead[:, cols].all()
        assert (got_i.numpy()[:, cols] == cols * group + group - 1).all()
    elif case == "duplicates":
        for b in range(B):
            assert got_i[b, (40 + b) // group] == 40 + b
    elif case == "last_lane_tie":
        cols = np.arange(2048 // group, 2304 // group)
        assert (got_i.numpy()[:, cols] == cols * group + group - 1).all()


@pytest.mark.parametrize("block_rows", BLOCKS)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("case", K1_CASES)
def test_grouped_topk_pallas_matches_reference(case, group, block_rows):
    q, E, valid = _k1_inputs(case)
    want_v, want_i = ref_scan.grouped_topk_pallas(
        jnp.asarray(q), jnp.asarray(E, jnp.bfloat16), jnp.asarray(valid), k=8,
        block_rows=block_rows, group=group, interpret=True)
    got_v, got_i = port_scan.grouped_topk_pallas(
        _t(q), _t(E, torch.bfloat16), _t(valid), 8, block_rows=block_rows, group=group)
    _assert_same_winners(got_v, got_i, np.asarray(want_v), np.asarray(want_i), q, E, valid)
    assert np.all(valid[got_i.numpy()] > 0)          # masked rows never surface
    assert got_i.dtype == torch.int32


# Edges of the CUDA kernel's tiling (128 rows x 256 queries x 64-wide D
# slices), held on the twin: groups wider than a row tile (2,048 rows: 16
# tiles folded) and D = 80, not a multiple of the D slice.
K1_EDGES = ((2048, 2048, 64), (2048, 4096, 64), (64, 2048, 80), (256, 2048, 80))


@pytest.mark.parametrize("group,block_rows,dim", K1_EDGES)
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_group_twin_matches_pallas_interpret_at_tile_edges(case, group, block_rows, dim):
    q, E, valid = _k1_inputs(case, dim=dim)
    want_v, want_i = _ref_groups(q, E, valid, group, block_rows)
    got_v, got_i = port_scan.grouped_max_reference(
        _t(q, torch.bfloat16), _t(E, torch.bfloat16), _t(valid), group)
    assert got_v.shape == (B, GN // group)
    _assert_same_winners(got_v, got_i, want_v, want_i, q, E, valid)
    if case == "duplicates":        # two copies of q[b] in one group: the later wins
        for b in range(B):
            assert got_i[b, (40 + b) // group] == 40 + b


def _misaligned(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t that starts `offset` elements into its buffer."""
    buf = torch.zeros(t.numel() + offset + 16, dtype=t.dtype)
    return buf[offset:offset + t.numel()].view_as(t).copy_(t)


# 1 element in (2 or 4 bytes); 9 bf16 elements in = one row of a 9-wide buffer
@pytest.mark.parametrize("operand,offset", [("q", 1), ("E", 1), ("E", 9), ("valid", 1)])
def test_grouped_max_cuda_refuses_misaligned_bases(operand, offset):
    """The kernel's TMA copies need 16-byte-aligned bases: a misaligned
    operand raises ValueError before any launch."""
    q, E, valid = _k1_inputs("random")
    args = {"q": _t(q, torch.bfloat16), "E": _t(E, torch.bfloat16), "valid": _t(valid)}
    args[operand] = _misaligned(args[operand], offset)
    before = port_scan.grouped_max_cuda.launches
    with pytest.raises(ValueError, match="16-byte"):
        port_scan.grouped_max_cuda(args["q"], args["E"], args["valid"], 256)
    assert port_scan.grouped_max_cuda.launches == before


def test_grouped_max_cuda_alignment_check_passes_aligned_views():
    """A view 8 bf16 elements (16 bytes) in passes the alignment check and
    meets the device check instead."""
    q, E, valid = _k1_inputs("random")
    with pytest.raises(ValueError, match="CUDA"):
        port_scan.grouped_max_cuda(_t(q, torch.bfloat16), _misaligned(_t(E, torch.bfloat16), 8),
                                   _t(valid), 256)


def test_grouped_topk_pallas_checks_its_layout():
    q, E, valid = _k1_inputs("random")
    with pytest.raises(ValueError):
        port_scan.grouped_topk_pallas(_t(q), _t(E), _t(valid), 8, block_rows=3000, group=64)
    with pytest.raises(ValueError):
        port_scan.grouped_topk_pallas(_t(q), _t(E), _t(valid), 8, block_rows=1024, group=96)


def test_grouped_max_cuda_refuses_cpu_tensors():
    q, E, valid = _k1_inputs("random")
    with pytest.raises(ValueError, match="CUDA"):
        port_scan.grouped_max_cuda(_t(q, torch.bfloat16), _t(E, torch.bfloat16),
                                   _t(valid), 256)


def test_profile_grouped_runs_tiny_on_the_cpu():
    from yams_tpu_torch.scripts import profile_grouped

    r = profile_grouped.run(N=8000, D=64, B=8, iters=2, block=1024, group=64,
                            windows=1, device="cpu")
    assert r["device"] == "cpu" and r["shape"]["N"] == 8192
    assert r["kernel_qps"] > 0 and r["matmul_topc_qps"] > 0
    assert r["matmul_topc_recall10"] == 1.0           # its top-C is exact
    assert 0.5 <= r["kernel_recall10"] <= 1.0
    assert r["overlap10"] == r["kernel_recall10"]     # the matmul path is the oracle


def test_fused_scan_split_cuts_the_kernel_after_its_mainloop(tmp_path):
    """The measurement script's copy of csrc/ differs from it only by the
    stub after the mainloop call of the fused scans and of K3."""
    from yams_tpu_torch import _build
    from yams_tpu_torch.scripts import fused_scan_split as split

    dest = split.mainloop_only_sources(tmp_path / "src")
    assert set(split.CUT) == {"fused_scan.cu", "exact_topk.cu"}
    for src in _build._SRC_DIR.iterdir():
        got = (dest / src.name).read_text()
        if src.name in split.CUT:
            assert got == src.read_text().replace(split.MARK, split.MARK + split.STUB, 1)
            assert got.count(split.STUB) == 1
        else:
            assert got == src.read_text()


def test_fused_scan_split_needs_a_card():
    from yams_tpu_torch.scripts import fused_scan_split

    with pytest.raises(ValueError, match="CUDA"):
        fused_scan_split.run(device="cpu")


# -- the int8 tier and merge_topk ------------------------------------------------
def test_quantize_int8_bit_equal():
    """The port's host copy of quantize_int8: the same int8 codes and f32
    scales bit for bit, including an all-zero row (scale 1e-12 / 127) and
    values on rounding half-way points."""
    rng = np.random.default_rng(21)
    mat = rng.standard_normal((300, D)).astype(np.float32)
    mat[5] = 0.0
    mat[6] = np.linspace(-1.0, 1.0, D, dtype=np.float32)
    mat[7, :4] = [127.0, 63.5, -0.5, 1.5]
    got_q, got_s = port_scan.quantize_int8(mat)
    want_q, want_s = ref_scan.quantize_int8(mat)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    assert np.array_equal(got_q, want_q)
    assert np.array_equal(got_s.view(np.uint32), want_s.view(np.uint32))


def _int8_inputs(case: str, k: int, seed: int = 0):
    q, E, valid = _inputs(case, k, seed)
    q8, scale = ref_scan.quantize_int8(E)
    return q, q8, scale, valid


@pytest.mark.parametrize("case", ["random", "duplicates", "sparse"])
def test_int8_scores_bit_equal(case):
    """Values bit-equal: the int32 sums are exact and the dequantization
    runs (s * qscale) * row_scale in the reference's order; the query is
    quantized on the device with round-half-to-even, as jnp.round."""
    q, q8, scale, valid = _int8_inputs(case, 10, seed=22)
    want = np.asarray(ref_scan.int8_scores(jnp.asarray(q), jnp.asarray(q8),
                                           jnp.asarray(scale), jnp.asarray(valid)))
    got = port_scan.int8_scores(torch.from_numpy(q), torch.from_numpy(q8),
                                torch.from_numpy(scale), torch.from_numpy(valid)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", K_CASES)
def test_int8_topk_scan_matches_reference(case, k):
    """ids equal, values bit-equal, and the (-1e30, -1) carry slots where
    fewer than k rows are live kept as the reference keeps them."""
    q, q8, scale, valid = _int8_inputs(case, k, seed=23)
    wv, wi = ref_scan.int8_topk_scan(jnp.asarray(q), jnp.asarray(q8), jnp.asarray(scale),
                                     jnp.asarray(valid), k=k, block_rows=BR)
    gv, gi = port_scan.int8_topk_scan(torch.from_numpy(q), torch.from_numpy(q8),
                                      torch.from_numpy(scale), torch.from_numpy(valid),
                                      k, block_rows=BR)
    assert gi.dtype == torch.int32
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gv.numpy().view(np.uint32), np.asarray(wv).view(np.uint32))
    if case == "sparse":
        assert (gi.numpy()[:, k - 1:] == -1).all()


def test_int8_topk_scan_chunks_merge_like_the_block_scan(monkeypatch):
    """A chunk of the port's scan holds many 512-row blocks; with a score
    budget of one block per chunk the result is the same."""
    q, q8, scale, valid = _int8_inputs("duplicates", 10, seed=24)
    args = (torch.from_numpy(q), torch.from_numpy(q8), torch.from_numpy(scale),
            torch.from_numpy(valid), 10)
    whole = port_scan.int8_topk_scan(*args, block_rows=BR)
    monkeypatch.setattr(port_scan, "_SCORE_BUDGET", B * BR)
    blocks = port_scan.int8_topk_scan(*args, block_rows=BR)
    assert all(torch.equal(a, b) for a, b in zip(whole, blocks))


def test_int8_mm_pads_the_query_side_only_on_a_card():
    """On the CPU the product is torch._int_mm as it is, and exact."""
    rng = np.random.default_rng(25)
    a = torch.from_numpy(rng.integers(-127, 128, (3, 40)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (24, 40)).astype(np.int8))
    got = port_scan.int8_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (3, 24)
    assert torch.equal(got, a.int() @ b.int().t())


@pytest.mark.parametrize("k", [1, 10])
def test_merge_topk_matches_reference(k):
    """Per-shard candidate lists with ties across and inside shards: the
    merge keeps the earlier list's entry, as lax.top_k over the concat."""
    rng = np.random.default_rng(26)
    vals = [np.round(rng.random((B, 10)), 1).astype(np.float32) for _ in range(3)]
    vals = [np.sort(v, axis=1)[:, ::-1].copy() for v in vals]
    idx = [rng.integers(0, 1000, (B, 10)).astype(np.int32) for _ in range(3)]
    wv, wi = ref_scan.merge_topk([jnp.asarray(v) for v in vals],
                                 [jnp.asarray(i) for i in idx], k)
    gv, gi = port_scan.merge_topk([torch.from_numpy(v) for v in vals],
                                  [torch.from_numpy(i) for i in idx], k)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gv.numpy(), np.asarray(wv))
