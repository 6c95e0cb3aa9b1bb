"""Vector index whose device view is torch tensors.

The host state (f32 rows, validity, row -> doc slot map, free list) and all
mutations are yams_tpu's VectorIndex, inherited. `device_arrays` is the one
method on the search path that touched jax; here it uploads torch tensors to
an explicit device. Every mutation re-uploads the whole matrix on the next
search: the reference's dirty-block splicing is not ported yet.
"""

from __future__ import annotations

import torch

from yams_tpu.index.vector_index import VectorIndex as _ReferenceIndex


class VectorIndex(_ReferenceIndex):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.device_dtype != "bfloat16":
            raise NotImplementedError(
                f"device_dtype={self.device_dtype!r}: only the bf16 tier is ported")
        self._torch_view: tuple | None = None  # ((gen, cap, device), arrays)

    def device_arrays(self, device: torch.device):
        """(E bf16 (cap, D), valid f32 (cap,), row2slot i32 (cap,),
        row_scale f32 (cap,)) on `device`, re-uploaded after any mutation."""
        with self._lock:
            key = (self.mutation_gen, self.capacity, device)
            if self._torch_view is not None and self._torch_view[0] == key:
                return self._torch_view[1]
            self._torch_view = None  # drop the stale copy before uploading
            # copy=True: a CPU view must not alias the mutable host arrays
            e = torch.from_numpy(self._vecs).to(device).to(torch.bfloat16)
            valid = torch.from_numpy(self._valid).to(device, copy=True)
            slots = torch.from_numpy(self._slots).to(device, copy=True)
            scale = torch.ones(self.capacity, dtype=torch.float32, device=device)
            self.upload_bytes_total += (
                self._vecs.nbytes + self._valid.nbytes + self._slots.nbytes)
            arrays = (e, valid, slots, scale)
            self._torch_view = (key, arrays)
            return arrays

    def search(self, *args, **kwargs):
        raise NotImplementedError("VectorIndex.search (Pallas scan tiers) is not ported")
