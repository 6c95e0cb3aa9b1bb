"""Device meshes for corpus-sharded retrieval, driven from one process.

Port of yams_tpu/parallel/mesh.py. The reference is single-controller: its
mesh is `jax.devices()` of the serving process, and XLA inserts the
collectives of a shard_map program. Here a mesh is a grid of
`torch.device`s with axis names; a shard is a tensor on its device, and
the collectives are plain tensor operations on the mesh's lead device:

  - all_gather (lax.all_gather tiled): concatenation in mesh order;
  - pmax: elementwise max of the parts; psum: their sum, in mesh order.

One process queues each shard's work on its own card (CUDA launches are
asynchronous), and only the (B, C) candidate lists cross to the lead card.
Several shards may sit on one device: `virtual_mesh` builds such a mesh,
the counterpart of the reference's --xla_force_host_platform_device_count,
for the CPU tests and a one-card host. `corpus_mesh` counts real devices
only, as the reference's does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device


class Mesh:
    """An n-d array of torch devices with one name per axis.

    `devices.flat` is the row-major shard order; `shape` maps each axis
    name to its size, as jax.sharding.Mesh.shape does."""

    def __init__(self, devices, axis_names):
        self.devices = np.empty(np.shape(devices), dtype=object)
        self.devices[...] = devices
        self.axis_names = ((axis_names,) if isinstance(axis_names, str)
                           else tuple(axis_names))
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device the collectives gather on: the first of the mesh."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def visible_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """Every card torch sees for "cuda" (raises without one), the one CPU
    device for "cpu". AppContext arms the sharded tier through this
    function, so a test can stand eight CPU devices in for eight cards."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def corpus_mesh(n_devices: int | None = None, axis: str = "d",
                device: str | torch.device = "cuda") -> Mesh:
    """A 1-D mesh over the first n visible devices (all by default)."""
    devices = visible_devices(device)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} available")
    return Mesh(np.array(devices[:n], dtype=object), (axis,))


def virtual_mesh(shape: int | tuple[int, ...], axis_names="d",
                 device: str | torch.device = "cuda") -> Mesh:
    """A mesh whose every shard sits on one device: the sharded programs run
    shard by shard there (a one-card host, the CPU tests)."""
    dev = resolve_device(device)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    grid = np.empty(shape, dtype=object)
    grid[...] = dev
    return Mesh(grid, axis_names)


def pad_to_shards(n: int, n_shards: int, block_rows: int = 1) -> int:
    """Smallest multiple of n_shards*block_rows >= n (shard-even row count)."""
    unit = n_shards * block_rows
    return ((max(n, 1) + unit - 1) // unit) * unit


def axes_of(axis: str | tuple[str, ...]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def shard_grid(mesh: Mesh, axis: str | tuple[str, ...]) -> np.ndarray:
    """The devices that hold the row shards over `axis`, shaped by its axes
    (outermost first): shard i is `grid.flat[i]`. Over a subset of the
    mesh's axes the other axes hold replicas; the first replica computes."""
    axes = axes_of(axis)
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} not in the mesh's {mesh.axis_names}")
    rest = [i for i, a in enumerate(mesh.axis_names) if a not in axes]
    order = rest + [mesh.axis_names.index(a) for a in axes]
    grid = mesh.devices.transpose(order)
    return grid[(0,) * len(rest)]


def shard_devices(mesh: Mesh, axis: str | tuple[str, ...]) -> list[torch.device]:
    """The row shards' devices in shard order (row-major over `axis`)."""
    return list(shard_grid(mesh, axis).flat)


def shard_rows(mesh: Mesh, x, axis: str | tuple[str, ...] = "d") -> list[torch.Tensor]:
    """Row-shard x over `axis`: a tensor is split into equal parts along dim
    0, each moved to its shard's device; a list of parts (one a shard, as
    VectorIndex.sharded_device_arrays gives) is checked and moved where a
    part sits elsewhere."""
    devices = shard_devices(mesh, axis)
    if isinstance(x, torch.Tensor):
        if x.shape[0] % len(devices):
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"{len(devices)} shards")
        parts = x.chunk(len(devices), dim=0)
    else:
        parts = list(x)
        if len(parts) != len(devices):
            raise ValueError(f"{len(parts)} parts for {len(devices)} shards")
    return [p.to(d) for p, d in zip(parts, devices)]


class Replicas:
    """One copy of a replicated tensor on each device that asks for it
    (a single copy where every shard shares the device)."""

    def __init__(self, x: torch.Tensor | None):
        self.x = x
        self._on: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor | None:
        if self.x is None:
            return None
        got = self._on.get(device)
        if got is None:
            got = self._on[device] = self.x.to(device)
        return got


# -- collectives: each moves its parts to the lead device ---------------------
def all_gather(parts: list[torch.Tensor], dim: int = 1,
               device: torch.device | None = None) -> torch.Tensor:
    """lax.all_gather(tiled=True): the parts concatenated along `dim` in
    mesh order, on `device` (the first part's by default)."""
    dev = device or parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def pmax(parts: list[torch.Tensor], device: torch.device | None = None) -> torch.Tensor:
    """lax.pmax: the elementwise max of the parts."""
    dev = device or parts[0].device
    return functools.reduce(torch.maximum, [p.to(dev) for p in parts])


def psum(parts: list[torch.Tensor], device: torch.device | None = None) -> torch.Tensor:
    """lax.psum: the sum of the parts, added in mesh order."""
    dev = device or parts[0].device
    return functools.reduce(torch.add, [p.to(dev) for p in parts])
