"""Port parity: the strided-window scan K2 and flash_topc (ops/flash_topk.py).

Seeded NumPy corpora of two 16,384-row spans go through yams_tpu's
windowed_scan / flash_topc (the Pallas kernel in interpret mode on the CPU,
as tests/test_flash_topk.py runs it) and the port's, whose window step on a
CPU tensor is the plain twin `windowed_scan_reference`. Values agree to
1e-5 (f32 sums of bf16 products in another order); ids agree wherever the
value is above -1e29 except at near-ties (the two true scores within
1e-5); an all-masked window holds the TPU kernel's (-1e30, 0), row 0 and
not a row of that window, since its scratch starts there and the fold is a
strict `>`; equal scores in one window go to the first row.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yams_tpu.ops import flash_topk as ref_flash
from yams_tpu_torch.ops import flash_topk as port_flash

SPAN, WINDOW, NEG = port_flash.SPAN, port_flash.WINDOW, port_flash.NEG
N, B = 2 * SPAN, 8
CASES = ("random", "masked_window", "duplicates")


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(case: str, D: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    E = _unit(rng.standard_normal((N, D)))
    q = _unit(rng.standard_normal((B, D)))
    bias = np.zeros(N, np.float32)
    bias[::7] = NEG                                   # every 7th row masked
    if case == "masked_window":     # every row of window (0, 5) and (1, 127)
        bias[5:SPAN:WINDOW] = NEG
        bias[SPAN + 127::WINDOW] = NEG
    elif case == "duplicates":      # copies of q[b] in window (0, 3 + b): the first wins
        for b in range(B):
            rows = [3 + b + WINDOW * c for c in (9, 40, 41)]
            E[rows] = q[b]
            bias[rows] = 0.0
    return q, E, bias


def _assert_same_winners(got_v, got_i, want_v, want_i, q, E):
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, atol=1e-5, rtol=0)
    diff = got_i != want_i
    assert not (diff & (want_v <= -1e29)).any(), "dead slots must match exactly"
    qb = np.asarray(jnp.asarray(q, jnp.bfloat16), np.float64)
    eb = np.asarray(jnp.asarray(E, jnp.bfloat16), np.float64)
    for b, c in zip(*np.nonzero(diff)):
        assert abs(qb[b] @ eb[got_i[b, c]] - qb[b] @ eb[want_i[b, c]]) <= 1e-5, (b, c)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_window_twin_matches_pallas_interpret(case, D):
    q, E, bias = _inputs(case, D)
    want_v, want_i = ref_flash.windowed_scan(
        jnp.asarray(q), jnp.asarray(E, jnp.bfloat16), jnp.asarray(bias), interpret=True)
    got_v, got_i = port_flash.windowed_scan(_t(q), _t(E).to(torch.bfloat16), _t(bias))
    assert got_v.shape == (B, N // SPAN * WINDOW) and got_i.dtype == torch.int32
    _assert_same_winners(got_v, got_i, want_v, want_i, q, E)
    if case == "masked_window":
        for col in (5, 2 * WINDOW - 1):
            assert (got_v[:, col] == NEG).all() and (got_i[:, col] == 0).all()
            assert (np.asarray(want_i)[:, col] == 0).all()
    elif case == "duplicates":
        for b in range(B):
            assert got_i[b, 3 + b] == 3 + b + WINDOW * 9


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_flash_topc_matches_reference(case, D):
    q, E, bias = _inputs(case, D, seed=1)
    want_v, want_i = ref_flash.flash_topc(
        jnp.asarray(q), jnp.asarray(E, jnp.bfloat16), jnp.asarray(bias), k=16,
        interpret=True)
    got_v, got_i = port_flash.flash_topc(_t(q), _t(E).to(torch.bfloat16), _t(bias), k=16)
    _assert_same_winners(got_v, got_i, want_v, want_i, q, E)
    assert np.all(bias[got_i.numpy()] == 0)           # masked rows never surface


def test_flash_topc_recall_on_clustered():
    """tests/test_flash_topk.py's clustered case on the port: selection
    recall@10 against the exact top-10 >= 0.95, and the values are the
    selected rows' exact f32 scores."""
    rng = np.random.default_rng(1)
    n, D, b, K = SPAN, 64, 16, 10
    centers = _unit(rng.standard_normal((64, D)))
    E = _unit(centers[rng.integers(0, 64, n)] + 0.35 * rng.standard_normal((n, D)))
    q = _unit(rng.standard_normal((b, D)))
    v, i = port_flash.flash_topc(_t(q), _t(E).to(torch.bfloat16), torch.zeros(n), k=K)
    v, i = v.numpy(), i.numpy()
    s = np.asarray(jnp.dot(jnp.asarray(q, jnp.bfloat16), jnp.asarray(E, jnp.bfloat16).T,
                           preferred_element_type=jnp.float32))
    exact = np.argsort(-s, axis=1)[:, :K]
    rec = np.mean([len(np.intersect1d(i[r], exact[r])) / K for r in range(b)])
    assert rec >= 0.95, rec
    np.testing.assert_allclose(v, np.take_along_axis(s, i.astype(np.int64), 1),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [SPAN + 100, 2 * SPAN])
def test_pad_corpus_matches_reference(n):
    rng = np.random.default_rng(2)
    E = rng.standard_normal((n, 32)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    got, want = port_flash.pad_corpus(E, bias), ref_flash.pad_corpus(E, bias)
    assert got[0].shape[0] % SPAN == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1][n:] == NEG).all()


def test_windowed_scan_refuses_ragged_corpus():
    q, E, bias = _inputs("random", 64)
    with pytest.raises(ValueError, match="pad_corpus"):
        port_flash.windowed_scan(_t(q), _t(E[:-1]), _t(bias[:-1]))


@pytest.mark.parametrize("case", CASES)
def test_window_twin_matches_pallas_interpret_at_d80(case):
    """D = 80 is not a multiple of the CUDA kernel's 64-wide D slice."""
    q, E, bias = _inputs(case, 80, seed=3)
    want_v, want_i = ref_flash.windowed_scan(
        jnp.asarray(q), jnp.asarray(E, jnp.bfloat16), jnp.asarray(bias), interpret=True)
    got_v, got_i = port_flash.windowed_scan(_t(q), _t(E).to(torch.bfloat16), _t(bias))
    _assert_same_winners(got_v, got_i, want_v, want_i, q, E)
    if case == "masked_window":
        assert (got_v[:, 5] == NEG).all() and (got_i[:, 5] == 0).all()


def _misaligned(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t that starts `offset` elements into its buffer."""
    buf = torch.zeros(t.numel() + offset + 16, dtype=t.dtype)
    return buf[offset:offset + t.numel()].view_as(t).copy_(t)


# 1 element in (2 or 4 bytes); 9 bf16 elements in = one row of a 9-wide buffer
@pytest.mark.parametrize("operand,offset", [("q", 1), ("E", 1), ("E", 9), ("bias", 1)])
def test_windowed_scan_cuda_refuses_misaligned_bases(operand, offset):
    """The kernel's TMA copies need 16-byte-aligned bases: a misaligned
    operand raises ValueError before any launch."""
    q, E, bias = _inputs("random", 64)
    args = {"q": _t(q).to(torch.bfloat16), "E": _t(E).to(torch.bfloat16), "bias": _t(bias)}
    args[operand] = _misaligned(args[operand], offset)
    before = port_flash.windowed_scan_cuda.launches
    with pytest.raises(ValueError, match="16-byte"):
        port_flash.windowed_scan_cuda(args["q"], args["E"], args["bias"])
    assert port_flash.windowed_scan_cuda.launches == before


def test_windowed_scan_cuda_alignment_check_passes_aligned_views():
    """A view 8 bf16 elements (16 bytes) in passes the alignment check and
    meets the device check instead."""
    q, E, bias = _inputs("random", 64)
    with pytest.raises(ValueError, match="CUDA"):
        port_flash.windowed_scan_cuda(_t(q).to(torch.bfloat16),
                                      _misaligned(_t(E).to(torch.bfloat16), 8), _t(bias))


def test_windowed_scan_cuda_refuses_cpu_tensors():
    q, E, bias = _inputs("random", 64)
    with pytest.raises(ValueError, match="CUDA"):
        port_flash.windowed_scan_cuda(_t(q).to(torch.bfloat16), _t(E).to(torch.bfloat16),
                                      _t(bias))


def test_exp_flash_topk_runs_tiny_on_the_cpu():
    from yams_tpu_torch.scripts import exp_flash_topk

    r = exp_flash_topk.run(N=SPAN, D=64, B=8, iters=2, n_clusters=64, windows=1,
                           device="cpu")
    assert r["device"] == "cpu" and r["shape"]["N"] == SPAN
    assert r["kernel_qps"] > 0 and r["matmul_topc_qps"] > 0
    assert r["matmul_topc_recall10"] == 1.0           # its top-C is exact
    assert r["kernel_recall10"] >= 0.9
    with pytest.raises(ValueError):
        exp_flash_topk.run(N=SPAN + 1, D=64, B=8, device="cpu")
