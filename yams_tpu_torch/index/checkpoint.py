"""Sharded device-array checkpoints with epoch stamps.

Port of yams_tpu/index/checkpoint.py. The reference writes its sharded
arrays with orbax, which needs JAX; the port keeps its own layout, in which
each shard is written from its own device (no gather through one device)
and restore re-lays the rows onto any layout:

    <dir>/arrays/<key>/<i>.npy   one file a saved shard, in row order
    <dir>/meta.json              {"epoch", "keys"} (the reference's fields)
                                 + "arrays": {key: {"shape", "dtype",
                                 "rows": [[lo, hi], ...]}}

bf16 is stored as its uint16 bits, with "bfloat16" recorded as the dtype.
A save writes the arrays into a temporary directory beside `arrays/` and
renames it into place once complete, then replaces meta.json (itself
written to a temporary file first), so an overwrite never leaves a
half-written array under `arrays/`. `checkpoint_epoch` reads meta.json
alone, so it also reads a directory the reference wrote.

Epochs mirror TopologyArtifacts.epoch: a checkpoint carries the epoch it was
built at, and a restore that requires a later one raises, as the
reference's staleness stamps do.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import uuid

import numpy as np
import torch

from ..parallel.mesh import Mesh, shard_devices

_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _host_parts(leaf) -> list[np.ndarray]:
    """A leaf -> its row parts on the host: a list of per-shard tensors, or
    one tensor or array. bf16 parts come back as their uint16 bits."""
    parts = list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]
    out = []
    for p in parts:
        if isinstance(p, torch.Tensor):
            p = p.detach()
            if p.dtype == torch.bfloat16:
                p = p.view(torch.int16).cpu().numpy().view(np.uint16)
            else:
                p = p.cpu().numpy()
        out.append(np.ascontiguousarray(p))
    return out


def _dtype_name(leaf) -> str:
    first = leaf[0] if isinstance(leaf, (list, tuple)) else leaf
    if isinstance(first, torch.Tensor):
        return str(first.dtype).removeprefix("torch.")
    return np.asarray(first).dtype.name


def save_sharded(directory: str | pathlib.Path, tree: dict, *, epoch: int) -> None:
    """Save a dict of arrays: each value a tensor, a NumPy array, or a list
    of per-shard tensors (row parts in shard order, as
    VectorIndex.sharded_device_arrays gives). Overwrites any checkpoint at
    this path."""
    d = pathlib.Path(directory).resolve()
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".arrays.tmp-{uuid.uuid4().hex}"
    meta = {"epoch": int(epoch), "keys": sorted(tree), "arrays": {}}
    try:
        for key in sorted(tree):
            if "/" in key or key.startswith("."):
                raise ValueError(f"checkpoint key {key!r} must be a plain name")
            leaf = tree[key]
            parts = _host_parts(leaf)
            (tmp / key).mkdir(parents=True)
            rows, lo = [], 0
            for i, p in enumerate(parts):
                np.save(tmp / key / f"{i}.npy", p, allow_pickle=False)
                if p.ndim:
                    rows.append([lo, lo + p.shape[0]])
                    lo += p.shape[0]
            shape = [lo, *parts[0].shape[1:]] if parts[0].ndim else []
            meta["arrays"][key] = {"shape": shape, "dtype": _dtype_name(leaf),
                                   "rows": rows}
        old = d / f".arrays.old-{uuid.uuid4().hex}"
        if (d / "arrays").exists():
            (d / "arrays").rename(old)
        tmp.rename(d / "arrays")
        meta_tmp = d / f".meta.json.tmp-{uuid.uuid4().hex}"
        meta_tmp.write_text(json.dumps(meta))
        os.replace(meta_tmp, d / "meta.json")
        shutil.rmtree(old, ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def checkpoint_epoch(directory: str | pathlib.Path) -> int | None:
    p = pathlib.Path(directory) / "meta.json"
    if not p.exists():
        return None
    return int(json.loads(p.read_text())["epoch"])


@dataclasses.dataclass(frozen=True)
class ShardedTemplate:
    """The layout a restore places an array in: its shape and dtype, and
    `spec` over `mesh` (the reference's PartitionSpec as a tuple: a mesh
    axis, or a tuple of axes, for dim 0 row-shards the array; None for
    every dim replicates it, one copy on the mesh's lead device)."""
    shape: tuple[int, ...]
    dtype: str
    mesh: Mesh
    spec: tuple

    @property
    def devices(self) -> list[torch.device] | None:
        """The shards' devices, or None for a replicated array."""
        if any(s is not None for s in self.spec[1:]):
            raise ValueError(f"spec {self.spec}: only dim 0 may be sharded")
        if not self.spec or self.spec[0] is None:
            return None
        return shard_devices(self.mesh, self.spec[0])


def sharded_template(arr_like, mesh: Mesh, spec) -> ShardedTemplate:
    """Template for restore_sharded: the shape and dtype of arr_like laid
    out as `spec` over `mesh`."""
    return ShardedTemplate(tuple(np.shape(arr_like)), _dtype_name(arr_like), mesh,
                           tuple(spec))


def _read_rows(src: pathlib.Path, info: dict, lo: int, hi: int) -> np.ndarray:
    """Rows lo..hi of a saved array, read from the saved shards they
    overlap (memory-mapped, so a shard is read only where it is needed)."""
    out = []
    for i, (a, b) in enumerate(info["rows"]):
        if b <= lo or a >= hi:
            continue
        part = np.load(src / f"{i}.npy", mmap_mode="r", allow_pickle=False)
        out.append(np.array(part[max(lo, a) - a:min(hi, b) - a]))   # a copy off the map
    if not out:
        return np.empty((0, *info["shape"][1:]))
    return out[0] if len(out) == 1 else np.concatenate(out)


def _to_tensor(a: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    if dtype in _TORCH_DTYPES:     # stored as unsigned bits of the same width
        a = a.view(np.int16)
    t = torch.from_numpy(a)
    if dtype in _TORCH_DTYPES:
        t = t.view(_TORCH_DTYPES[dtype])
    return t.to(device)


def restore_sharded(directory: str | pathlib.Path, abstract_tree: dict, *,
                    min_epoch: int = 0) -> tuple[dict, int]:
    """Restore to the layouts of abstract_tree (a dict of ShardedTemplate):
    a row-sharded template gives a list of per-shard tensors, each on its
    device, whatever shard count the checkpoint was saved with; a
    replicated one gives one tensor on the mesh's lead device. Raises
    FileNotFoundError without a checkpoint, ValueError when it is older
    than min_epoch (the staleness-stamp contract) or its arrays do not
    match the templates."""
    d = pathlib.Path(directory).resolve()
    epoch = checkpoint_epoch(d)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint at {d}")
    if epoch < min_epoch:
        raise ValueError(f"stale checkpoint: epoch {epoch} < required {min_epoch}")
    meta = json.loads((d / "meta.json").read_text())
    if "arrays" not in meta:
        raise ValueError(f"{d} holds no port checkpoint (an orbax one?)")
    out = {}
    for key, tpl in abstract_tree.items():
        info = meta["arrays"].get(key)
        if info is None:
            raise ValueError(f"checkpoint at {d} has no array {key!r}")
        if tuple(info["shape"]) != tuple(tpl.shape) or info["dtype"] != tpl.dtype:
            raise ValueError(f"{key}: saved {info['shape']} {info['dtype']}, template "
                             f"{list(tpl.shape)} {tpl.dtype}")
        src, n = d / "arrays" / key, (tpl.shape[0] if tpl.shape else 0)
        devices = tpl.devices
        if devices is None:
            whole = (np.load(src / "0.npy", allow_pickle=False) if not tpl.shape
                     else _read_rows(src, info, 0, n))
            out[key] = _to_tensor(whole, tpl.dtype, tpl.mesh.lead)
            continue
        if n % len(devices):
            raise ValueError(f"{key}: {n} rows do not split over {len(devices)} shards")
        rows = n // len(devices)
        out[key] = [_to_tensor(_read_rows(src, info, i * rows, (i + 1) * rows),
                               tpl.dtype, dev) for i, dev in enumerate(devices)]
    return out, epoch
