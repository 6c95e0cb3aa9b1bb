"""Per-document token-embedding store for late-interaction rerank.

Port of yams_tpu/index/token_index.py. The host arrays, their growth,
`set_doc` and `remove_doc` are the reference's: each doc slot keeps up to
`max_tokens` token embeddings in a capacity-padded (slots, Td, D) f32
array with a (slots, Td) mask. The device view (bf16 tokens, f32 mask)
lives on the index's device (the card unless the caller asks for the
CPU), rebuilt whole after a change, and `gather` runs there.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve_device


class TokenIndex:
    def __init__(self, dim: int, max_tokens: int = 32, capacity: int = 1024, *,
                 device: str | torch.device = "cuda"):
        self.dim = dim
        self.max_tokens = max_tokens
        self.device = resolve_device(device)
        cap = max(capacity, 1)
        self._tok = np.zeros((cap, max_tokens, dim), np.float32)
        self._mask = np.zeros((cap, max_tokens), np.float32)
        self._dirty = True
        self._device = None
        self._lock = threading.RLock()
        self._count = 0

    @property
    def capacity(self) -> int:
        return self._tok.shape[0]

    @property
    def doc_count(self) -> int:
        return self._count

    def _grow(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        add = new_cap - self.capacity
        self._tok = np.concatenate(
            [self._tok, np.zeros((add, self.max_tokens, self.dim), np.float32)]
        )
        self._mask = np.concatenate(
            [self._mask, np.zeros((add, self.max_tokens), np.float32)]
        )

    def set_doc(self, slot: int, token_vecs: np.ndarray) -> None:
        """token_vecs (n, D); keeps the first max_tokens."""
        token_vecs = np.asarray(token_vecs, np.float32)[: self.max_tokens]
        with self._lock:
            if slot >= self.capacity:
                self._grow(slot + 1)
            n = len(token_vecs)
            self._tok[slot] = 0.0
            self._mask[slot] = 0.0
            if n:
                self._tok[slot, :n] = token_vecs
                self._mask[slot, :n] = 1.0
                self._count = max(self._count, slot + 1)
            self._dirty = True

    def remove_doc(self, slot: int) -> None:
        with self._lock:
            if slot < self.capacity:
                self._mask[slot] = 0.0
                self._dirty = True

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(tok bf16 (cap, Td, D), mask f32 (cap, Td)) on the device."""
        with self._lock:
            if self._dirty or self._device is None:
                self._device = (
                    torch.tensor(self._tok, device=self.device).to(torch.bfloat16),
                    torch.tensor(self._mask, device=self.device),
                )
                self._dirty = False
            return self._device

    def gather(self, slots: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Device gather of candidate docs' tokens: slots (B, C) ->
        (tok (B, C, Td, D), mask (B, C, Td))."""
        tok, mask = self.device_arrays()
        slots = slots.to(self.device)
        s = slots.clamp(0, self.capacity - 1).long()
        live = (slots >= 0) & (slots < self.capacity)
        return tok[s], mask[s] * live[:, :, None]
