"""DynamicBatcher: token-budget batch sizing for embedding calls.

Parity: include/yams/vector/dynamic_batcher.h:34-39 (chars/4 token estimator,
budget-bounded batches). Used by the daemon's embedding stage to keep device
launches large but bounded.

Copied from yams_tpu/embed/batcher.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


def estimate_tokens(text: str) -> int:
    return max(1, len(text) // 4)


class DynamicBatcher:
    def __init__(self, max_tokens: int = 16384, max_items: int = 256):
        self.max_tokens = max_tokens
        self.max_items = max_items

    def batches(
        self, items: Iterable[T], text_of=lambda x: x
    ) -> Iterator[list[T]]:
        batch: list[T] = []
        budget = 0
        for item in items:
            t = estimate_tokens(text_of(item))
            if batch and (budget + t > self.max_tokens or len(batch) >= self.max_items):
                yield batch
                batch, budget = [], 0
            batch.append(item)
            budget += t
        if batch:
            yield batch
