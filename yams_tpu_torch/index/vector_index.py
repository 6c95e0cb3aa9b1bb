"""Vector index: host rows with a torch device view, and its search tiers.

Copied from yams_tpu/index/vector_index.py as a class of its own: the host
state (capacity-padded f32 rows, validity, row -> doc slot map, free list,
block-granular dirty sets, `upload_bytes_total`) and the mutations that
touch only it (`add`, `remove_doc`, `_grow`, `_mark_dirty`, the identity
layout check, `_gather_blocks`, `slots_of_rows`, `stats`). Everything that
touched jax is ported, on the index's device (the card unless the caller
asks for the CPU):

  - device_arrays: the dense view, bf16 or (device_dtype "int8") int8
    codes with per-row dequant scales quantized on the host; after
    mutations only the dirty blocks are quantized, uploaded and spliced
    into copies (a reader may still hold the old tensors), counted in
    `upload_bytes_total` as the reference counts;
  - search: exact KNN, the plain scan or the block kernel K3; an int8
    index always takes the int8 scan, as the reference's does;
  - add: encodes new rows with the port's pq_encode once PQ is built;
  - build_pq / _pq_arrays / search_pq: the PQ tiers. The unfiltered grouped
    PQ4 scan goes to kernel K4 (`_use_pallas_adc`), everything else to the
    plain pq_adc_topk. The device rerank of an int8 index reads a bf16
    mirror uploaded once and spliced with the PQ state;
  - save / load: the reference's files (vectors.npz, vectors.json and the
    pq.npz sidecar, format v3, with its v1 -> v2 -> v3 migrations), read
    and written with NumPy alone, so either package loads the other's.
    `load` takes the device dtype and the device: the reference's loader
    passes no dtype, so an int8 index it reopens comes back bf16.
  - sharded_device_arrays: the row-sharded view of the dense tier over a
    parallel.mesh.Mesh, one list of per-shard tensors an array.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time

import numpy as np
import torch

from ..core.errors import CorruptionError, InvalidArgumentError, UnsupportedError
from ..device import resolve_device
from ..ops.pq import (PQCodebook, exact_rerank, pq4_pack, pq_adc_topk, pq_encode,
                      pq_train)
from ..ops.pq_pallas import pq4_adc_topk_pallas
from ..ops.scan import exact_topk_pallas, exact_topk_scan, int8_topk_scan, quantize_int8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class VectorIndex:
    def __init__(
        self,
        dim: int,
        capacity: int = 1 << 14,
        block_rows: int = 2048,
        space_id: str = "",
        device_dtype: str = "bfloat16",
        *,
        device: str | torch.device = "cuda",
    ):
        if device_dtype not in ("bfloat16", "int8"):
            raise ValueError(f"device_dtype={device_dtype!r}: bfloat16 or int8")
        self.device = resolve_device(device)
        self.dim = dim
        self.block_rows = block_rows
        self.space_id = space_id
        self.device_dtype = device_dtype
        cap = _round_up(max(capacity, block_rows), block_rows)
        self._vecs = np.zeros((cap, dim), dtype=np.float32)
        self._valid = np.zeros(cap, dtype=np.float32)
        self._slots = np.full(cap, -1, dtype=np.int32)  # row -> doc slot
        self._count = 0  # high-water mark of used rows
        self._free: list[int] = []
        self._rows_by_slot: dict[int, list[int]] = {}
        # block-granular dirty tracking: mutations record row//block_rows;
        # device_arrays() re-uploads only dirty blocks unless a full rebuild
        # (grow / first build) is pending
        self._dirty_full = True
        self._dirty_blocks: set[int] = set()
        self._pq_dirty_blocks: set[int] = set()
        self.upload_bytes_total = 0  # instrumentation: host->device traffic
        self._device = None  # (E bf16, valid f32, row2slot i32, row_scale f32)
        self.mutation_gen = 0  # bumps on every mutation
        self._sharded = None  # (key, per-shard arrays): sharded_device_arrays
        self._lock = threading.RLock()

    # -- capacity ---------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._vecs.shape[0]

    @property
    def active_rows(self) -> int:
        return int(self._valid.sum())

    def _grow(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        add = new_cap - self.capacity
        self._vecs = np.vstack([self._vecs, np.zeros((add, self.dim), np.float32)])
        self._valid = np.concatenate([self._valid, np.zeros(add, np.float32)])
        self._slots = np.concatenate([self._slots, np.full(add, -1, np.int32)])
        self._dirty_full = True
        if self.has_pq:
            # keep codes capacity-sized (the scans reshape by block); new
            # rows encode lazily in add()
            self._pq_codes = np.vstack([
                self._pq_codes,
                np.zeros((add, self._pq_codes.shape[1]), np.uint8),
            ])
            self._pq_device = None        # device shapes changed: full
            self._pq_valid_device = None  # re-upload on next _pq_arrays
            self._pq_rerank_device = None

    def _upload(self, a: np.ndarray, dtype: torch.dtype | None = None,
                device: torch.device | None = None) -> torch.Tensor:
        """Host array -> a fresh tensor on the index's device, or `device`
        (never a view of `a`)."""
        dev = device or self.device
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(dtype).to(dev) if dtype is not None else t.to(dev, copy=True)

    def _splice(self, dst: torch.Tensor, src: np.ndarray, blocks: list[int],
                dtype: torch.dtype | None = None) -> tuple[torch.Tensor, int]:
        """A copy of `dst` with the listed blocks re-uploaded from `src`, and
        the bytes uploaded (the reference's batched blocks, padded to a power
        of two by repeating the last; re-writing those rows is idempotent)."""
        stacked, starts = self._gather_blocks(src, blocks)
        return self._splice_rows(dst, stacked.reshape(-1, *src.shape[1:]), starts, dtype)

    def _splice_rows(self, dst: torch.Tensor, rows_host: np.ndarray, starts: np.ndarray,
                     dtype: torch.dtype | None = None) -> tuple[torch.Tensor, int]:
        """A copy of `dst` with the stacked blocks starting at `starts`
        replaced by `rows_host`, and the bytes uploaded."""
        part = self._upload(rows_host, dtype)
        rows = (torch.from_numpy(starts.astype(np.int64))[:, None]
                + torch.arange(self.block_rows)).reshape(-1).to(self.device)
        return dst.clone().index_copy_(0, rows, part), part.nbytes

    # -- mutation ----------------------------------------------------------------
    def add(self, vectors: np.ndarray, doc_slots: np.ndarray | list[int]) -> list[int]:
        """Insert rows; returns assigned row indices (the reference's add)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        doc_slots = np.asarray(doc_slots, dtype=np.int32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise InvalidArgumentError(
                f"expected (M, {self.dim}) vectors, got {vectors.shape}")
        if len(doc_slots) != len(vectors):
            raise InvalidArgumentError("doc_slots/vectors length mismatch")
        with self._lock:
            rows = []
            for _ in range(len(vectors)):
                if self._free:
                    r = self._free.pop()
                else:
                    if self._count >= self.capacity:
                        self._grow(self._count + len(vectors))
                    r = self._count
                    self._count += 1
                rows.append(r)
            rows_np = np.array(rows, dtype=np.int64)
            self._vecs[rows_np] = vectors
            self._valid[rows_np] = 1.0
            self._slots[rows_np] = doc_slots
            for r, s in zip(rows, doc_slots.tolist()):
                self._rows_by_slot.setdefault(s, []).append(r)
            if self.has_pq:
                # incremental encode with the existing codebook
                codes = pq_encode(self._pq_codebook, vectors).cpu().numpy()
                if self._pq_packed4:
                    codes = pq4_pack(codes)
                self._pq_codes[rows_np] = codes
            self._mark_dirty(rows_np)
            return rows

    def remove_doc(self, doc_slot: int) -> int:
        """Tombstone all rows of a doc slot; rows are recycled."""
        with self._lock:
            rows = self._rows_by_slot.pop(doc_slot, [])
            if rows:
                rows_np = np.array(rows, dtype=np.int64)
                self._valid[rows_np] = 0.0
                self._slots[rows_np] = -1
                self._free.extend(rows)
                self._mark_dirty(rows_np)
            return len(rows)

    def _mark_dirty(self, rows_np: np.ndarray) -> None:
        self._identity = None
        self.mutation_gen += 1
        for b in np.unique(rows_np // self.block_rows):
            self._dirty_blocks.add(int(b))
            # PQ device state (codes/mask/rerank mirror) splices the same
            # dirty blocks in _pq_arrays — never a full re-upload per add
            self._pq_dirty_blocks.add(int(b))

    def rows_for_slot(self, doc_slot: int) -> list[int]:
        return list(self._rows_by_slot.get(doc_slot, []))

    # -- device view ----------------------------------------------------------------
    @property
    def identity_layout(self) -> bool:
        """True iff every live row's slot equals its row index (flat corpora:
        exactly one vector per doc, no tombstones) — enables the engine's
        rows_are_docs / streaming fast paths."""
        with self._lock:
            if getattr(self, "_identity", None) is None:
                n = self._count
                self._identity = bool(
                    not self._free
                    and np.all(self._valid[:n] == 1.0)
                    and np.array_equal(
                        self._slots[:n], np.arange(n, dtype=np.int32)
                    )
                )
            return self._identity

    def device_arrays(self):
        """(E (cap, D), valid f32 (cap,), row2slot i32 (cap,), row_scale f32
        (cap,)) on the index's device. E is bf16 with unit scales, or int8
        codes with per-row dequant scales when device_dtype is "int8"."""
        with self._lock:
            if self._device is None or self._dirty_full:
                self._device = None   # drop the stale copy before uploading
                if self.device_dtype == "int8":
                    q8, scale = quantize_int8(self._vecs)
                    e, scale = self._upload(q8), self._upload(scale)
                else:
                    e = self._upload(self._vecs, torch.bfloat16)
                    scale = torch.ones(self.capacity, dtype=torch.float32,
                                       device=self.device)
                arrays = (e, self._upload(self._valid), self._upload(self._slots), scale)
                self._device = arrays
                self.upload_bytes_total += sum(a.nbytes for a in arrays)
                self._identity = None  # recomputed lazily
                self._dirty_full = False
                self._dirty_blocks.clear()
            elif self._dirty_blocks:
                # publish the new tuple only after every splice succeeded
                e, valid, slots, scale = self._device
                bs = sorted(self._dirty_blocks)
                if self.device_dtype == "int8":
                    # quantize the dirty blocks alone; their scales splice too
                    stacked, starts = self._gather_blocks(self._vecs, bs)
                    q8, sc = quantize_int8(stacked.reshape(-1, self.dim))
                    e, n_e = self._splice_rows(e, q8, starts)
                    scale, n_sc = self._splice_rows(scale, sc, starts)
                    n_e += n_sc
                else:
                    e, n_e = self._splice(e, self._vecs, bs, torch.bfloat16)
                valid, n_v = self._splice(valid, self._valid, bs)
                slots, n_s = self._splice(slots, self._slots, bs)
                self.upload_bytes_total += n_e + n_v + n_s
                self._device = (e, valid, slots, scale)
                self._dirty_blocks.clear()
            return self._device

    def sharded_device_arrays(self, mesh, axis: str | tuple[str, ...] = "d"):
        """(E, valid, row2slot, row_scale) row-sharded over `mesh`'s `axis`:
        four lists of per-shard tensors, shard i on its own device (the
        serving view parallel.sharded_hybrid_query reads).

        Cached per (mutation_gen, device dtype, mesh devices, axis): any
        mutation re-places the whole corpus on the next use, the
        reference's contract (ingest arrives in batches). int8 codes are
        quantized over the whole capacity, as the reference does. Rows are
        capacity-padded, so a shard count dividing the capacity is
        required."""
        from ..parallel.mesh import shard_devices

        with self._lock:
            key = (self.mutation_gen, self.device_dtype,
                   tuple(str(d) for d in mesh.devices.flat), axis)
            if self._sharded is not None and self._sharded[0] == key:
                return self._sharded[1]
            devices = shard_devices(mesh, axis)
            if self.capacity % len(devices):
                raise ValueError(f"capacity {self.capacity} not divisible by "
                                 f"{len(devices)} shards")
            self._sharded = None    # drop the stale placement before uploading
            rows = self.capacity // len(devices)
            if self.device_dtype == "int8":
                e_host, scale_host = quantize_int8(self._vecs)
                e_dtype = None
            else:
                e_host, e_dtype = self._vecs, torch.bfloat16
                scale_host = np.ones(self.capacity, np.float32)

            def place(a, dtype=None):
                return [self._upload(a[i * rows:(i + 1) * rows], dtype, d)
                        for i, d in enumerate(devices)]

            arrays = (place(e_host, e_dtype), place(self._valid), place(self._slots),
                      place(scale_host))
            self.upload_bytes_total += sum(p.nbytes for parts in arrays for p in parts)
            self._sharded = (key, arrays)
            return arrays

    def _gather_blocks(self, src: np.ndarray, blocks: list[int]):
        """Stack dirty blocks for one batched splice. Padded to a power of
        two by repeating the last block (re-splicing the same rows is
        idempotent) so the updater jit cache sees O(log blocks) shapes.
        Returns (stacked (nb, block_rows, ...), start offsets (nb,) i32)."""
        br = self.block_rows
        nb = 1 << max(len(blocks) - 1, 0).bit_length()
        padded = blocks + [blocks[-1]] * (nb - len(blocks))
        stacked = np.stack([src[b * br:(b + 1) * br] for b in padded])
        return stacked, np.asarray([b * br for b in padded], np.int32)

    # -- search (standalone vector-only path) -------------------------------------
    def _queries(self, queries: np.ndarray) -> torch.Tensor:
        q = np.asarray(queries, dtype=np.float32)
        return torch.from_numpy(q[None, :] if q.ndim == 1 else q).to(self.device)

    def search(self, queries: np.ndarray, k: int = 10, use_pallas: bool = False):
        """Exact KNN over valid rows -> (values (B,k), row indices (B,k))."""
        E, valid, _, scale = self.device_arrays()
        q = self._queries(queries)
        if self.device_dtype == "int8":
            vals, idx = int8_topk_scan(q, E, scale, valid, k, block_rows=self.block_rows)
        elif use_pallas:
            vals, idx = exact_topk_pallas(q, E, valid, k, block_rows=self.block_rows)
        else:
            vals, idx = exact_topk_scan(q, E, valid, k, block_rows=self.block_rows)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def slots_of_rows(self, rows: np.ndarray) -> np.ndarray:
        return self._slots[np.asarray(rows, dtype=np.int64)]

    # -- PQ-ADC compressed path ----------------------------------------------------
    def build_pq(self, m: int = 32, train_limit: int = 4096, rerank_factor: int = 2,
                 ksub: int = 256, pack4: bool = False, group: int = 1) -> None:
        """Train codebooks on current rows + encode everything (see the
        reference's build_pq for the tiers and `group`)."""
        # validate everything BEFORE mutating state
        if pack4 and ksub > 16:
            raise ValueError("pack4 requires ksub <= 16")
        if self.dim % m:
            raise ValueError(f"dim {self.dim} not divisible by m={m}")
        if pack4 and m % 2:
            raise ValueError(f"pack4 requires even m, got {m}")
        if group < 1 or self.block_rows % group:
            raise ValueError(
                f"group {group} must divide block_rows {self.block_rows}")
        with self._lock:
            active = self._vecs[: max(self._count, 1)]
            codebook = pq_train(active, m=m, ksub=ksub, train_limit=train_limit,
                                device=self.device)
            codes = pq_encode(codebook, self._vecs).cpu().numpy()
            self._pq_codebook = codebook
            self._pq_codes = pq4_pack(codes) if pack4 else codes
            self._pq_packed4 = pack4
            self._pq_rerank_factor = rerank_factor
            self._pq_group = group
            self._pq_device = None

    @property
    def has_pq(self) -> bool:
        return getattr(self, "_pq_codebook", None) is not None

    def _pq_arrays(self):
        """Device-resident PQ state: (codes u8, centroids f32, valid f32,
        slots i32). Never touches device_arrays(), so the capacity tier never
        uploads the dense matrix; mutations splice only their dirty blocks."""
        with self._lock:
            if (getattr(self, "_pq_device", None) is None
                    or getattr(self, "_pq_valid_device", None) is None
                    or getattr(self, "_pq_slots_device", None) is None):
                codes = self._upload(self._pq_codes)
                vdev = self._upload(self._valid)
                sdev = self._upload(self._slots)
                self.upload_bytes_total += codes.nbytes + vdev.nbytes + sdev.nbytes
                self._pq_device = (codes, self._pq_codebook.centroids)
                self._pq_valid_device = vdev
                self._pq_slots_device = sdev
                self._pq_dirty_blocks.clear()
            elif self._pq_dirty_blocks:
                codes, cent = self._pq_device
                bs = sorted(self._pq_dirty_blocks)
                codes, n_c = self._splice(codes, self._pq_codes, bs)
                vdev, n_v = self._splice(self._pq_valid_device, self._valid, bs)
                sdev, n_s = self._splice(self._pq_slots_device, self._slots, bs)
                self.upload_bytes_total += n_c + n_v + n_s
                if getattr(self, "_pq_rerank_device", None) is not None:
                    self._pq_rerank_device, n_r = self._splice(
                        self._pq_rerank_device, self._vecs, bs, torch.bfloat16)
                    self.upload_bytes_total += n_r
                self._pq_device = (codes, cent)
                self._pq_valid_device = vdev
                self._pq_slots_device = sdev
                self._pq_dirty_blocks.clear()
            return (*self._pq_device, self._pq_valid_device, self._pq_slots_device)

    def _use_pallas_adc(self, packed4: bool, group: int, centroids, doc_mask) -> bool:
        """Route the unfiltered grouped PQ4 scan to the K4 kernel
        (ops/pq_pallas.py); the plain pq_adc_topk keeps the filtered scan,
        ksub != 16 and the ungrouped/unpacked tiers. Env YAMS_PQ_PALLAS:
        0 = off, 1 = force (the plain twin on the CPU), auto = on a card."""
        mode = os.environ.get("YAMS_PQ_PALLAS", "auto")
        if mode == "0":
            return False
        if not (packed4 and group > 1 and doc_mask is None
                and centroids.shape[1] == 16):
            return False
        pblock = min(2048, self.capacity)
        if pblock % group or self.capacity % pblock:
            return False
        return mode == "1" or self.device.type == "cuda"

    def _pallas_adc_candidates(self, c: int, group: int) -> int:
        """K4 emits one candidate per group window, so at most
        capacity // group rows can come back: clamp c to the window count
        (the exact rerank still sees every window's best)."""
        return min(c, self.capacity // group)

    def _adc_candidates(self, q: torch.Tensor, c: int, dm: torch.Tensor | None = None):
        """The ADC scan's top-c candidates of device queries q -> (values,
        rows), each (B, c'): K4 on the unfiltered grouped PQ4 tier (one
        candidate a window, so c' may be below c), else the plain scan with
        the doc mask dm."""
        codes, centroids, valid, slots = self._pq_arrays()
        group = self._pq_group
        if self._use_pallas_adc(self._pq_packed4, group, centroids, dm):
            # the kernel's block is independent of the index block: capacity
            # is a power-of-two multiple of it, so min(2048, capacity) divides it
            return pq4_adc_topk_pallas(
                q, codes, centroids, valid, self._pallas_adc_candidates(c, group),
                group=group, block_rows=min(2048, self.capacity),
                sel_width=int(getattr(self, "_pq_sel_width", 0)))
        return pq_adc_topk(
            q, codes, centroids, valid, k=c, block_rows=self.block_rows,
            packed4=self._pq_packed4, group=group,
            slots=slots if dm is not None else None, doc_mask=dm)

    def search_pq(self, queries: np.ndarray, k: int = 10, rerank: str = "auto",
                  doc_mask: np.ndarray | None = None):
        """ADC scan + exact rerank x rerank_factor -> (values, row indices).

        rerank: 'device' rescores against the dense bf16 view, 'host' against
        the f32 host rows (the capacity tier: the dense matrix never reaches
        the device); 'auto' picks device only when that view is resident.
        doc_mask: optional (num_slots,) or (B, num_slots) 0/1 doc filter
        pushed into the ADC scan."""
        if not self.has_pq:
            raise RuntimeError("call build_pq() first")
        q = self._queries(queries)
        if rerank == "auto":
            rerank = "device" if self._device is not None else "host"
        dm = None
        if doc_mask is not None:
            dm = np.asarray(doc_mask, np.float32)
            dm = torch.from_numpy(dm[None, :] if dm.ndim == 1 else dm).to(self.device)
        av, ai = self._adc_candidates(q, min(k * self._pq_rerank_factor, self.capacity), dm)
        k_out = min(k, av.shape[1])
        if rerank == "host":
            cand = ai.cpu().numpy()                          # (B, C)
            qh = q.cpu().numpy()
            gathered = self._vecs[np.maximum(cand, 0)]       # (B, C, D)
            s = np.einsum("bcd,bd->bc", gathered, qh, dtype=np.float32)
            # ADC score <= -1e29 marks rows the scan masked: rescoring them
            # would resurrect deleted docs
            s = np.where((cand >= 0) & (av.cpu().numpy() > -1e29), s, -1e30)
            order = np.argsort(-s, axis=1)[:, :k_out]
            return (np.take_along_axis(s, order, axis=1),
                    np.take_along_axis(cand, order, axis=1))
        if self.device_dtype == "int8":
            # the rerank wants more precision than the int8 scan tier: a
            # bf16 mirror stays resident (uploaded once, spliced after)
            with self._lock:
                if getattr(self, "_pq_rerank_device", None) is None:
                    self._pq_rerank_device = self._upload(self._vecs, torch.bfloat16)
                    self.upload_bytes_total += self._pq_rerank_device.nbytes
                E = self._pq_rerank_device
        else:
            E = self.device_arrays()[0]
        vals, idx = exact_rerank(q, E, ai, av, -1e29, k=k_out)
        return vals.cpu().numpy(), idx.cpu().numpy()

    # -- persistence -----------------------------------------------------------------
    # The reference's versioned on-disk schema: v1 = no version stamp; v2
    # adds format_version + disk_dtype (float16 disk storage; load widens
    # back to float32); v3 adds the optional pq.npz sidecar (codebooks +
    # codes, so a restart never retrains or re-encodes).
    FORMAT_VERSION = 3

    def save(self, directory: str | pathlib.Path,
             disk_dtype: str = "float32") -> None:
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        with self._lock:
            np.savez_compressed(
                d / "vectors.npz",
                vecs=self._vecs[: self._count].astype(disk_dtype),
                valid=self._valid[: self._count],
                slots=self._slots[: self._count],
            )
            if self.has_pq:
                cb = self._pq_codebook
                np.savez_compressed(
                    d / "pq.npz",
                    codes=self._pq_codes[: self._count],
                    centroids=cb.centroids.cpu().numpy().astype(np.float32),
                    params=np.array(
                        [cb.m, cb.ksub, cb.dsub,
                         int(getattr(self, "_pq_packed4", False)),
                         self._pq_rerank_factor,
                         getattr(self, "_pq_built_rows", self._count),
                         getattr(self, "_pq_group", 1)],
                        np.int64),
                )
            elif (d / "pq.npz").exists():
                (d / "pq.npz").unlink()  # stale sidecar from a prior build
            (d / "vectors.json").write_text(json.dumps({
                "format_version": self.FORMAT_VERSION,
                "disk_dtype": disk_dtype,
                "dim": self.dim,
                "count": self._count,
                "space_id": self.space_id,
                "block_rows": self.block_rows,
                "has_pq": self.has_pq,
                "saved_at": time.time(),
            }))

    @staticmethod
    def _migrate_v1_to_v2(meta: dict, data: dict) -> tuple[dict, dict]:
        """v1 had no version stamp and always float32 vecs; validate shapes
        (v1 wrote no dtype contract) and stamp the v2 fields."""
        vecs = data["vecs"]
        if vecs.ndim != 2 or vecs.shape[1] != meta["dim"]:
            raise CorruptionError(
                f"v1 index shape {vecs.shape} inconsistent with dim "
                f"{meta['dim']}")
        data["vecs"] = vecs.astype(np.float32)
        meta["format_version"] = 2
        meta["disk_dtype"] = "float32"
        return meta, data

    @staticmethod
    def _migrate_v2_to_v3(meta: dict, data: dict) -> tuple[dict, dict]:
        """v3 only adds the optional pq.npz sidecar; a v2 tree is a valid v3
        tree with no persisted PQ state."""
        meta["format_version"] = 3
        meta["has_pq"] = False
        return meta, data

    _MIGRATIONS = {1: "_migrate_v1_to_v2", 2: "_migrate_v2_to_v3"}

    @classmethod
    def load(cls, directory: str | pathlib.Path, *, device_dtype: str = "bfloat16",
             device: str | torch.device = "cuda") -> "VectorIndex":
        """Reopen a saved index as `device_dtype` on `device`; the PQ
        centroids go to the device as a torch tensor."""
        d = pathlib.Path(directory)
        meta = json.loads((d / "vectors.json").read_text())
        with np.load(d / "vectors.npz") as raw:
            data = {k: raw[k] for k in raw.files}
        version = int(meta.get("format_version", 1))
        if version > cls.FORMAT_VERSION:
            raise UnsupportedError(
                f"vector index format v{version} is newer than this build "
                f"(max v{cls.FORMAT_VERSION})")
        while version < cls.FORMAT_VERSION:
            meta, data = getattr(cls, cls._MIGRATIONS[version])(meta, data)
            version = int(meta["format_version"])
        idx = cls(
            dim=meta["dim"],
            capacity=max(meta["count"], 1),
            block_rows=meta["block_rows"],
            space_id=meta.get("space_id", ""),
            device_dtype=device_dtype,
            device=device,
        )
        n = meta["count"]
        if n:
            idx._vecs[:n] = data["vecs"]      # widened to float32 on assignment
            idx._valid[:n] = data["valid"]
            idx._slots[:n] = data["slots"]
            idx._count = n
            for r in range(n):
                s = int(idx._slots[r])
                if idx._valid[r]:
                    idx._rows_by_slot.setdefault(s, []).append(r)
                else:
                    idx._free.append(r)
        if meta.get("has_pq") and (d / "pq.npz").exists():
            with np.load(d / "pq.npz") as pq:
                params = [int(x) for x in pq["params"]]
                centroids = np.asarray(pq["centroids"], np.float32)
                saved_codes = pq["codes"]
            m, ksub, dsub, packed4, rerank = params[:5]
            idx._pq_codebook = PQCodebook(
                centroids=torch.from_numpy(centroids).to(idx.device), m=m,
                ksub=ksub, dsub=dsub)
            codes = np.zeros((idx.capacity, saved_codes.shape[1]), np.uint8)
            codes[:n] = saved_codes
            idx._pq_codes = codes
            idx._pq_packed4 = bool(packed4)
            idx._pq_rerank_factor = rerank
            idx._pq_built_rows = params[5] if len(params) > 5 else n
            idx._pq_group = params[6] if len(params) > 6 else 1
            idx._pq_device = None
        return idx

    def stats(self) -> dict:
        return {
            "dim": self.dim,
            "capacity": self.capacity,
            "rows": self._count,
            "active_rows": self.active_rows,
            "docs": len(self._rows_by_slot),
            "space_id": self.space_id,
        }
