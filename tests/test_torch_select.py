"""select.top_k's card kernel, as far as the CPU can hold it.

`csrc/select_topk.cu` runs only on a card (`chip_smoke.py` phase 18 holds it
to the plain path there). Here: its long-row arithmetic written out in
PyTorch (`sliced_top_k`: each slice's top k under the key order, then their
merge) against `_key_top_k` followed by `_key_top_k_small` on adversarial
rows; the wrapper's choice of regime and slice length (`select_plan`); its
refusals; and `top_k` on a CPU tensor, which stays on the plain path.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yams_tpu_torch.ops import select
from yams_tpu_torch.ops.select import select_plan, select_topk_cuda, sliced_top_k, top_k


def key_order_top_k(x: torch.Tensor, k: int):
    """The order's definition: unique int64 keys over the whole row, then
    the k winners ordered by them."""
    pos = select._key_top_k(x, k)
    pos = pos.gather(1, select._key_top_k_small(x.gather(1, pos), pos))
    return x.gather(1, pos), pos


def adversarial(kind: str, n: int, seed: int) -> torch.Tensor:
    """(4, n) f32 rows of one kind."""
    g = np.random.default_rng(seed)
    if kind == "normal":
        x = g.standard_normal((4, n))
    elif kind == "one_value":
        x = np.full((4, n), 0.25)
    elif kind == "ties":          # a few distinct values: ties everywhere, across slices and the cut
        x = np.round(g.standard_normal((4, n)) * 2) / 2
    elif kind == "fills":         # -1e30 fills with few live columns (fewer than k in some rows)
        x = np.where(g.random((4, n)) < 0.97, -1e30, g.standard_normal((4, n)))
        x[0] = -1e30
    elif kind == "specials":      # -inf, +-0.0 and NaN among ties
        x = np.round(g.standard_normal((4, n)))
        x[:, ::5] = -np.inf
        x[:, 1::7] = 0.0
        x[:, 2::9] = -0.0
        x[1:, 3::31] = np.nan
        x[2, :] = -0.0
        x[2, ::3] = 0.0
    elif kind == "rising":        # every slice's scores beat the running k-th best
        x = np.tile(np.arange(n, dtype=np.float64), (4, 1)) * np.array([[1], [-1], [0.5], [1e-3]])
    else:
        raise ValueError(kind)
    return torch.from_numpy(x.astype(np.float32))


def assert_bits_equal(got, want):
    gv, gi = got
    wv, wi = want
    assert gi.dtype == torch.int64
    assert torch.equal(gi, wi)
    assert torch.equal(gv.float().view(torch.int32), wv.float().view(torch.int32))


KINDS = ["normal", "one_value", "ties", "fills", "specials", "rising"]
# (n, k, slice_len): n not a multiple of the slice, k == n, k == 1, a single
# slice, slices shorter than k, slice borders inside runs of ties
SHAPES = [(1000, 64, 128), (1000, 1, 100), (300, 300, 128), (300, 300, 1024),
          (4096, 64, 4096), (5000, 256, 2048), (777, 64, 50), (2048, 65, 64)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k,slice_len", SHAPES)
def test_sliced_top_k_is_the_key_order(kind, n, k, slice_len):
    x = adversarial(kind, n, seed=n + k)
    assert_bits_equal(sliced_top_k(x, k, slice_len), key_order_top_k(x, k))


def test_sliced_top_k_of_bf16_scores():
    x = adversarial("ties", 3000, seed=7).to(torch.bfloat16)
    v, i = sliced_top_k(x, 64, 512)
    wv, wi = key_order_top_k(x, 64)
    assert torch.equal(i, wi)
    assert torch.equal(v.view(torch.int32), wv.float().view(torch.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_top_k_takes_the_plain_path_and_the_key_order(kind):
    """Rows without a NaN: the plain path's repair makes it the key order."""
    x = adversarial(kind, 3000, seed=3)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    rows, kernel_rows, syncs = top_k.rows, top_k.kernel_rows, top_k.syncs
    got = top_k(x, 64)
    assert (top_k.rows - rows, top_k.kernel_rows - kernel_rows, top_k.syncs - syncs) == (4, 0, 1)
    assert_bits_equal(got, key_order_top_k(x, 64))


@pytest.mark.parametrize("rows,n,k,plan", [
    (1024, 1_000_448, 64, (1, 1_001_472)),  # the bf16 tier's vector leg
    (1024, 262_144, 64, (1, 262_144)),      # a streamed int8 block, bulk
    (64, 262_144, 64, (8, 32_768)),         # a streamed int8 block, interactive
    (1024, 4_096, 64, (0, 0)),              # the lexical leg's candidates
    (1024, 2_624, 64, (0, 0)),              # the streaming merge: 64 + 40 x 64
    (1024, 128, 64, (0, 0)),                # the fusion's final top-k
    (1, 8_192, 1_024, (0, 0)),
    (1, 8_193, 1_024, (1, 10_240)),         # stage 2 holds 8 x 1,024 keys at most
    (1, 1 << 20, 1_024, (8, 131_072)),
    (1, 1 << 20, 64, (128, 8_192)),
    (300, 1 << 20, 64, (1, 1 << 20)),       # one wave: 528 CTAs at most
    (100_000, 1 << 20, 64, (1, 1 << 20)),   # rows alone fill the card
])
def test_select_plan(rows, n, k, plan):
    assert select_plan(rows, n, k) == plan


@pytest.mark.parametrize("rows", [1, 7, 64, 1024, 50_000])
@pytest.mark.parametrize("n", [8_193, 10_000, 100_003, 1_000_448, 3_000_000])
@pytest.mark.parametrize("k", [1, 64, 256, 1_024])
def test_select_plan_invariants(rows, n, k):
    slices, slice_len = select_plan(rows, n, k)
    assert slices >= 1 and slice_len % 2048 == 0 and slice_len >= min(n, 8192)
    assert (slices - 1) * slice_len < n <= slices * slice_len   # no empty slice
    assert slices * k <= 8192                                   # stage 2 fits one CTA
    # one wave of CTAs (132 SMs x 4), as far as the slices' floor of 8,192
    # columns and stage 2's 8,192 keys allow; the rounding of slice_len to
    # 2,048 columns costs at most a fifth of the slices
    assert rows * slices <= max(132 * 4, rows)
    assert slices >= int(0.8 * max(1, min(132 * 4 // rows, n // 8192, 8192 // k)))


def test_kernel_takes():
    x = torch.zeros(4, 100)
    assert select.kernel_takes(x, 1) and select.kernel_takes(x, 100)
    assert select.kernel_takes(x.to(torch.bfloat16), 64) and select.kernel_takes(x.half(), 64)
    assert not select.kernel_takes(x, 101)            # k > n: the plain path raises as before
    assert not select.kernel_takes(x, 0)
    assert not select.kernel_takes(torch.zeros(4, 2000), 1025)
    assert not select.kernel_takes(x.double(), 8)     # f64 is not exact in f32
    assert not select.kernel_takes(x.int(), 8)
    assert not select.kernel_takes(torch.zeros(100), 8)


@pytest.mark.parametrize("x,k", [
    (torch.zeros(4, 100), 8),                         # a CPU tensor
    (torch.zeros(4, 100), 101),                       # k > n
    (torch.zeros(4, 100), 0),
    (torch.zeros(4, 2000), 1025),
    (torch.zeros(4, 100, dtype=torch.float64), 8),
    (torch.zeros(2, 4, 100), 8),
])
def test_select_topk_cuda_refuses(x, k):
    launches = select_topk_cuda.launches
    with pytest.raises(ValueError):
        select_topk_cuda(x, k)
    assert select_topk_cuda.launches == launches
