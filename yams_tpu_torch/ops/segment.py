"""Segment max of (B, rows) chunk scores into (B, m) document slots.

`out[q, s] = max(out[q, s], x[q, r] for every row r with row2slot[r] == s)`;
rows whose slot is negative (a tombstone or padding) or not below m are
skipped. Max does not depend on order, so both versions equal
`scatter_reduce_` amax on the floats bit for bit, but where a slot's maximum
is a zero of both signs: there `scatter_reduce_` keeps the zero it met last
(`std::max`), these +0 (IEEE 754 maximum).

- `segment_max_cuda`: the hand-written kernel (csrc/segment_max.cu) on a
  CUDA tensor: one read of the live scores, one native integer atomic a run
  of consecutive rows at one slot, no host sync. `search/fusion.py`
  `_aggregate_chunks` takes it for every amax segment on a card.
- `segment_max_plain`: the same function in PyTorch operations
  (`scatter_reduce_` amax on the scores' order-preserving integer images,
  so -0 < +0 there too), which the card checks compare the kernel with,
  beside `scatter_reduce_` amax on the floats themselves.
"""

from __future__ import annotations

import torch

from .. import _build

_GROUP = 64          # query rows a CTA walks its tile for (csrc/segment_max.cu kGroup)
_PLAIN_ROWS = 64     # query rows segment_max_plain takes at a time


def segment_max_cuda(x: torch.Tensor, row2slot: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the segment max kernel on CUDA tensors: x (B, rows) f32,
    row2slot (rows,) int32, out (B, m) f32, all contiguous on one device;
    `out` is updated in place and returned. Raises ValueError on anything
    else. Counts its launches in `segment_max_cuda.launches`."""
    if x.dtype != torch.float32 or out.dtype != torch.float32 or row2slot.dtype != torch.int32:
        raise ValueError(f"segment_max_cuda takes f32 x and out and int32 row2slot: got "
                         f"{x.dtype}, {out.dtype}, {row2slot.dtype}")
    if (x.dim() != 2 or row2slot.dim() != 1 or out.dim() != 2
            or row2slot.shape[0] != x.shape[1] or out.shape[0] != x.shape[0]):
        raise ValueError(f"segment_max_cuda takes x (B, rows), row2slot (rows,) and out (B, m): "
                         f"got {tuple(x.shape)}, {tuple(row2slot.shape)}, {tuple(out.shape)}")
    if not (x.is_contiguous() and row2slot.is_contiguous() and out.is_contiguous()):
        raise ValueError("segment_max_cuda takes contiguous tensors")
    if x.device.type != "cuda" or row2slot.device != x.device or out.device != x.device:
        raise ValueError(f"segment_max_cuda needs CUDA tensors on one device: x on {x.device}, "
                         f"row2slot on {row2slot.device}, out on {out.device}")
    B, rows = x.shape
    m = out.shape[1]
    if rows >= 1 << 31 or m >= 1 << 31 or -(-B // _GROUP) > 65535:
        raise ValueError(f"segment_max_cuda: rows {rows} and m {m} below 2**31, "
                         f"B {B} at most {65535 * _GROUP}")
    err = _build.library().yt_segment_max(
        x.data_ptr(), row2slot.data_ptr(), out.data_ptr(), B, rows, m,
        torch.cuda.current_stream(x.device).cuda_stream)
    segment_max_cuda.launches += 1
    _build.check(err, "segment_max_cuda")
    return out


segment_max_cuda.launches = 0


def segment_max_plain(x: torch.Tensor, row2slot: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """segment_max_cuda's function in PyTorch operations, on any device:
    `scatter_reduce_` amax over the scores' order-preserving int32 images
    (`_image`), so that it is exact in any order and -0 < +0 as in the
    kernel; the skipped rows go to a sink column past m, which is dropped."""
    B, m = out.shape
    seg = torch.where((row2slot >= 0) & (row2slot < m), row2slot.long(), m)
    for lo in range(0, B, _PLAIN_ROWS):     # bounds the int32 images to (64, rows)
        part = out[lo:lo + _PLAIN_ROWS]
        b = part.shape[0]
        wide = torch.cat([_image(part), _image(part.new_full((b, 1), -torch.inf))], dim=1)
        wide.scatter_reduce_(1, seg[None, :].expand(b, -1), _image(x[lo:lo + b]),
                             reduce="amax", include_self=True)
        part.copy_(_image(wide[:, :m].contiguous()).view(torch.float32))
    return out


def _image(x: torch.Tensor) -> torch.Tensor:
    """The int32 image of f32 values whose signed order is float order
    (negative floats' magnitude bits flipped); its own inverse."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)
