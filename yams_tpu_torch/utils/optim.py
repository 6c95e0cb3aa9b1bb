"""The optimizer, schedule and losses the trainers take from optax, on torch.

The reference trains with optax (`NerModel.fit`, scripts/train_encoder*.py).
This module is written against optax's arithmetic, so both packages take
the same steps from the same weights and gradients:

- `AdamW`: `optax.adamw` (b1 0.9, b2 0.999, eps 1e-8 outside the square
  root, no eps inside it, bias correction by `1 - b**count` in f32, decay
  of every leaf, default weight decay optax's 1e-4), its learning rate a
  constant or a schedule read at the update count before the step, as
  `optax.scale_by_schedule` reads it. The moments live beside the leaves on
  their device and are updated with `torch._foreach_*` (a few launches a
  step for all the leaves).
- `warmup_cosine_decay_schedule`: optax's linear warmup joined to its
  cosine decay (to 0, exponent 1, as the encoder scripts run it),
  computed in f32 as optax computes it.
- `softmax_cross_entropy`: `optax.softmax_cross_entropy_with_integer_labels`,
  and the two losses built on it: `masked_token_ce` (NER: the masked mean
  over tokens) and `in_batch_ce` (the encoders: symmetric in-batch
  softmax over query x document similarities).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]
B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adamw's defaults, which the reference runs


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule (its end value 0, exponent 1):
    count -> learning rate (a Python float holding the f32 value optax
    computes)."""
    f32 = np.float32
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, got {decay_steps=}")

    def linear(count: int) -> np.float32:
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int) -> np.float32:
        c = min(f32(count), f32(cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        return f32(peak_value) * decay

    def schedule(count: int) -> float:
        return float(linear(count) if count < warmup_steps else cosine(count - warmup_steps))

    return schedule


class AdamW:
    """optax.adamw over a list of leaf tensors (see the module docstring).

    `step(grads)` applies one update in place, grads in the leaves' order."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: float | Schedule,
                 weight_decay: float = 1e-4):
        self.params = list(params)
        self.lr = learning_rate if callable(learning_rate) else (lambda _count: learning_rate)
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of the leaves, in place."""
        grads = list(grads)
        lr = self.lr(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(B1) ** f32(self.count))
        bc2 = float(f32(1) - f32(B2) ** f32(self.count))
        # mu = (1 - b1) g + b1 mu ; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - B1))
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2))
        # u = mu_hat / (sqrt(nu_hat) + eps) + wd p ; p += -lr u
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(..., C) logits, (...) integer labels -> (...) losses: logsumexp
    less the label's logit."""
    return torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]


def masked_token_ce(logits: torch.Tensor, tags: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The NER loss: per-token cross entropy averaged over the mask."""
    return (softmax_cross_entropy(logits, tags) * mask).sum() / mask.sum().clamp_min(1.0)


def in_batch_ce(qv: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """The encoders' loss: (B, D) queries against (B, D) documents, row i's
    positive in column i, logits x 20, the mean cross entropy of rows and
    of columns."""
    logits = qv @ dv.T * 20.0
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (softmax_cross_entropy(logits, labels).mean()
            + softmax_cross_entropy(logits.T, labels).mean()) * 0.5
