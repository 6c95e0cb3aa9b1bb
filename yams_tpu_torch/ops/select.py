"""Selection and scan helpers that reproduce the reference's tie and rounding
order, so the port's ids and scores are those of the JAX package.

- `top_k`: lax.top_k's contract (sorted descending, ties to the lower
  index). torch.topk leaves the order of equal values open, and equal scores
  are common here (duplicate titles embed identically; quantized impacts
  collide). Ties are settled with unique int64 keys: an order-preserving
  integer image of the f32 score in the high 32 bits, the reversed column
  index in the low 32. On the CPU (`_plain_top_k`) the keys order the k
  winners always, and a whole row only when a tie straddles the k-th place;
  on a card `select_topk_cuda` (csrc/select_topk.cu) selects by the keys
  alone, with no host sync.
- `prefix_sum`: jnp.cumsum's association order on the CPU (XLA rewrites the
  reduce-window into sequential runs of 16 plus a recursive scan of the run
  totals). Long f32 prefix sums drift by ~1e-5 absolute under another order,
  which is enough to flip near-tied segment sums.
"""

from __future__ import annotations

import torch

from .. import _build
from ..spans import span

_ROW_BLOCK = 64    # rows per top_k pass: bounds the int64 key buffer
_SCAN_BASE = 16

# select_topk_cuda's limits and shape plan (csrc/select_topk.cu)
_KERNEL_MAX_K = 1024
_SHORT_MAX = 8192           # columns one CTA a row holds
_CHUNK = 2048               # columns a stage-1 CTA reads between barriers
_MIN_SLICE = 4 * _CHUNK
_TARGET_CTAS = 132 * 4      # H100 SMs x the stage-1 CTAs resident on each: one wave
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)   # exact in f32


def _key_top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact tie-ordered top-k column indices via unique int64 keys."""
    cols = torch.arange(x.shape[1], device=x.device, dtype=torch.int64)
    return torch.cat([torch.topk(_order_keys(x[lo:lo + _ROW_BLOCK], cols), k, dim=1).indices
                      for lo in range(0, x.shape[0], _ROW_BLOCK)], dim=0)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, n) f32 -> (values (R, k), indices (R, k) int64), descending,
    ties broken toward the lower index.

    On a card, `select_topk_cuda` wherever it takes the shape (`kernel_takes`);
    elsewhere `_plain_top_k`. Counters (plain ints on this function, never
    reset): `syncs`, the host's waits for the device (`_plain_top_k`'s, one a
    call, which `portbench.spans` counts in a trace to check this counter);
    `rows`, the rows selected; `repair_rows`, the rows `_plain_top_k` redid;
    `kernel_rows`, the rows the kernel selected."""
    shape = x.shape
    n_rows = shape[0]
    if n_rows == 0:
        empty = torch.empty((0, k), dtype=torch.int64, device=x.device)
        return x.new_empty((0, k)), empty
    with span("top_k", rows=n_rows, cols=shape[1], k=k):
        top_k.rows += n_rows
        if x.device.type == "cuda" and kernel_takes(x, k):
            top_k.kernel_rows += n_rows
            return select_topk_cuda(x, k)
        return _plain_top_k(x, k)


top_k.syncs = top_k.rows = top_k.repair_rows = top_k.kernel_rows = 0


def _plain_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """top_k in PyTorch operations: torch.topk picks the right values; only
    which of the elements equal to the k-th value it keeps is open. Rows
    where every such element was kept need no repair; the rest (a tie
    straddling the cut) are redone with unique int64 keys, found by a
    `nonzero` whose size the host waits for (on a card a stream sync). The
    k winners are then ordered by the same keys."""
    vals, pos = torch.topk(x, k, dim=1)
    kth = vals[:, -1:]
    cut_ties = (x == kth).sum(dim=1) != (vals == kth).sum(dim=1)
    rows = torch.nonzero(cut_ties).flatten()      # the host waits here
    top_k.syncs += 1
    n_repair = rows.numel()
    if n_repair:
        top_k.repair_rows += n_repair
        with span("tie_repair", rows=n_repair):
            pos[rows] = _key_top_k(x[rows], k)
    sel = x.gather(1, pos)
    order = _key_top_k_small(sel, pos)
    pos = pos.gather(1, order)
    return x.gather(1, pos), pos


def kernel_takes(x: torch.Tensor, k: int) -> bool:
    """Whether select_topk_cuda takes this shape, dtype and k (its device
    aside): 2-D, a float type exact in f32, 1 <= k <= min(n, 1,024), and
    columns that fit 31 bits."""
    return (x.dim() == 2 and x.dtype in _KERNEL_DTYPES
            and 1 <= k <= min(x.shape[1], _KERNEL_MAX_K) and x.shape[1] < 1 << 31)


def select_plan(rows: int, n: int, k: int) -> tuple[int, int]:
    """select_topk_cuda's regime for an (rows, n) call at k: (0, 0), one CTA
    a row, for n <= 8,192; else (slices, slice_len) for the two stages.
    Slices are a multiple of 2,048 columns and at least 8,192 long, and a
    row has as many as fill the card's SMs once and no more (528 CTAs: a
    stage-1 CTA pays fixed work, its first threshold and last cut, so more
    slices cost more than they hide, and a second wave runs nearly empty),
    and few enough that stage 2's slices x k keys fit one CTA."""
    if n <= _SHORT_MAX:
        return 0, 0
    slices = max(1, min(_TARGET_CTAS // rows, n // _MIN_SLICE, _SHORT_MAX // k))
    slice_len = _cdiv(_cdiv(n, slices), _CHUNK) * _CHUNK
    return _cdiv(n, slice_len), slice_len


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def select_topk_cuda(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the tie-exact top-k kernel (csrc/select_topk.cu) on a CUDA
    (R, n) tensor: (values (R, k) in x's dtype, indices (R, k) int64), in
    `_key_top_k`'s total order. A bf16 or f16 x is selected as its exact f32
    image and its values gathered from x; a row stride is read in place."""
    if not kernel_takes(x, k):
        raise ValueError(f"select_topk_cuda takes a 2-D f32, bf16 or f16 tensor and "
                         f"1 <= k <= min(n, {_KERNEL_MAX_K}): got {x.dtype} "
                         f"{tuple(x.shape)}, k={k}")
    if x.device.type != "cuda":
        raise ValueError(f"select_topk_cuda needs a CUDA tensor, got {x.device}")
    R, n = x.shape
    xs = x if x.dtype == torch.float32 else x.float()
    if xs.stride(1) != 1 or (R > 1 and xs.stride(0) < n):
        xs = xs.contiguous()
    stride = xs.stride(0) if R > 1 else n
    slices, slice_len = select_plan(R, n, k)
    out_v = torch.empty((R, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((R, k), dtype=torch.int64, device=x.device)
    keys = torch.empty((R, slices, k), dtype=torch.int64, device=x.device) if slices else None
    if R:
        err = _build.library().yt_select_topk(
            xs.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            keys.data_ptr() if keys is not None else None, R, n, stride, k, slices, slice_len,
            torch.cuda.current_stream(x.device).cuda_stream)
        select_topk_cuda.launches += 1
        _build.check(err, "select_topk_cuda")
    return (out_v if x.dtype == torch.float32 else x.gather(1, out_i)), out_i


select_topk_cuda.launches = 0


def _order_keys(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys of x's values at columns `cols` (broadcast): the f32
    order image in the high 32 bits (negative floats' magnitude bits
    flipped, so that integer order is float order), 0xFFFFFFFF - column in
    the low 32; the larger key is the earlier place of top_k's order."""
    bits = x.float().contiguous().view(torch.int32)
    key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    key <<= 32
    key += 0xFFFFFFFF - cols
    return key


def sliced_top_k(x: torch.Tensor, k: int, slice_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's long-row arithmetic in plain PyTorch: each slice's top k
    (fewer where it is shorter) under the key order, then the top k of their
    union, values read back from the keys. Equal to top_k because the order
    is total."""
    n = x.shape[1]
    keys = _order_keys(x, torch.arange(n, device=x.device, dtype=torch.int64))
    parts = [torch.topk(keys[:, lo:lo + slice_len], min(k, slice_len, n - lo), dim=1).values
             for lo in range(0, n, slice_len)]
    best = torch.topk(torch.cat(parts, dim=1), k, dim=1).values
    ordered = (best >> 32).to(torch.int32)
    vals = (ordered ^ ((ordered >> 31) & 0x7FFFFFFF)).view(torch.float32)
    return vals, 0xFFFFFFFF - (best & 0xFFFFFFFF)


def _key_top_k_small(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Order k selected (value, column) pairs: value descending, column
    ascending."""
    return torch.argsort(_order_keys(vals, pos), dim=1, descending=True)


def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    cols = x.unbind(-1)
    out = [cols[0]]
    for c in cols[1:]:
        out.append(out[-1] + c)
    return torch.stack(out, dim=-1)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a (R, n) float tensor along dim 1."""
    n = x.shape[1]
    if n <= _SCAN_BASE:
        return _sequential_prefix(x)
    pad = (-n) % _SCAN_BASE
    runs = torch.nn.functional.pad(x, (0, pad)).reshape(x.shape[0], -1, _SCAN_BASE)
    run_prefix = _sequential_prefix(runs)
    totals = prefix_sum(run_prefix[:, :, -1])
    carry = torch.cat([torch.zeros_like(totals[:, :1]), totals[:, :-1]], dim=1)
    return (run_prefix + carry[:, :, None]).reshape(x.shape[0], -1)[:, :n]
