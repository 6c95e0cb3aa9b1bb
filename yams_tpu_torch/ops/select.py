"""Selection and scan helpers that reproduce the reference's tie and rounding
order, so the port's ids and scores are those of the JAX package.

- `top_k`: lax.top_k's contract (sorted descending, ties to the lower
  index). torch.topk leaves the order of equal values open, and equal scores
  are common here (duplicate titles embed identically; quantized impacts
  collide). Ties are settled with unique int64 keys: an order-preserving
  integer image of the f32 score in the high 32 bits, the reversed column
  index in the low 32 — over the k winners always, and over a whole row
  only when a tie straddles the k-th place.
- `prefix_sum`: jnp.cumsum's association order on the CPU (XLA rewrites the
  reduce-window into sequential runs of 16 plus a recursive scan of the run
  totals). Long f32 prefix sums drift by ~1e-5 absolute under another order,
  which is enough to flip near-tied segment sums.
"""

from __future__ import annotations

import torch

_ROW_BLOCK = 64    # rows per top_k pass: bounds the int64 key buffer
_SCAN_BASE = 16


def _key_top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact tie-ordered top-k column indices via unique int64 keys."""
    n = x.shape[1]
    rev = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    idx = []
    for lo in range(0, x.shape[0], _ROW_BLOCK):
        bits = x[lo:lo + _ROW_BLOCK].float().contiguous().view(torch.int32)
        # negative floats: flip the magnitude bits so integer order == float order
        ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
        key = ordered.to(torch.int64) << 32
        key += rev
        idx.append(torch.topk(key, k, dim=1).indices)
    return torch.cat(idx, dim=0)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, n) f32 -> (values (R, k), indices (R, k) int64), descending,
    ties broken toward the lower index.

    torch.topk picks the right values; only which of the elements equal to
    the k-th value it keeps is open. Rows where every such element was kept
    need no repair; the rest (a tie straddling the cut) are redone with
    unique int64 keys. The k winners are then ordered by the same keys."""
    if x.shape[0] == 0:
        empty = torch.empty((0, k), dtype=torch.int64, device=x.device)
        return x.new_empty((0, k)), empty
    vals, pos = torch.topk(x, k, dim=1)
    kth = vals[:, -1:]
    cut_ties = (x == kth).sum(dim=1) != (vals == kth).sum(dim=1)
    rows = torch.nonzero(cut_ties).flatten()
    if rows.numel():
        pos[rows] = _key_top_k(x[rows], k)
    sel = x.gather(1, pos)
    order = _key_top_k_small(sel, pos)
    pos = pos.gather(1, order)
    return x.gather(1, pos), pos


def _key_top_k_small(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Order k selected (value, column) pairs: value descending, column
    ascending."""
    bits = vals.float().contiguous().view(torch.int32)
    ordered = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64) << 32
    key = ordered + (0xFFFFFFFF - pos)
    return torch.argsort(key, dim=1, descending=True)


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
