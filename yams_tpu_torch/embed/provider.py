"""Simeon embedding provider on torch.

Port of yams_tpu/embed/provider.py `SimeonProvider` with the pieces of
yams_tpu/embed/simeon.py `SimeonEncoder` it runs. Tokenization and the
hashed n-gram sketch are the port's copy of the reference's host code
(embed/simeon.py `sketch_texts`, which runs the port's native C++ sketch
library when it builds, else Python). The
projection matrix is generated on the host with NumPy Philox exactly as the
reference's `_R_host` does; the bf16 rounding of it and of the sketches is
done by torch (`.bfloat16().float()`, round to nearest even) instead of
ml_dtypes, which gives the same values. Document encoding stays on the host
(NumPy sgemm over the bf16-rounded operands), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core.config import EmbeddingConfig
from ..device import resolve_device
from .simeon import sketch_texts, tokenize


def native_sketch_available() -> bool:
    """Whether `sketch_texts` runs the native C++ sketch library (built with
    the host compiler on first use) rather than its Python fallback."""
    return native.sketch_library() is not None


def bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 array -> the f32 image of its bf16 rounding (RNE)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
        .bfloat16().float().numpy()


def projection_host(config: EmbeddingConfig) -> np.ndarray:
    """Seeded ±1/sqrt(D) sign projection (S, D) as bf16-rounded f32 —
    the reference's SimeonEncoder._R_host."""
    rng = np.random.Generator(np.random.Philox(config.seed))
    signs = (rng.integers(0, 2, (config.sketch_dim, config.dim),
                          dtype=np.int8) * 2 - 1).astype(np.float32)
    return bf16_round(signs / np.sqrt(config.dim))


class SimeonProvider:
    """Default model-free provider (fixed_hash_384 profile)."""

    name = "simeon"

    def __init__(self, config: EmbeddingConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.config = config or EmbeddingConfig()
        self.device = resolve_device(device)
        self._r_host: np.ndarray | None = None
        self._eye: torch.Tensor | None = None
        self._qvec_cache: dict[str, np.ndarray] = {}

    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def space_id(self) -> str:
        return self.config.space_id

    def projection(self) -> np.ndarray:
        if self._r_host is None:
            self._r_host = projection_host(self.config)
        return self._r_host

    def encode(self, texts: list[str]) -> np.ndarray:
        """texts -> (B, dim) f32 L2-normalized embeddings (host)."""
        if not texts:
            return np.zeros((0, self.config.dim), dtype=np.float32)
        x = bf16_round(sketch_texts(texts, self.config)) @ self.projection()
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return x / np.maximum(n, 1e-9)

    def encode_tokens(self, text: str, max_tokens: int = 32) -> np.ndarray:
        toks = tokenize(text)[:max_tokens]
        if not toks:
            return np.zeros((0, self.dim), np.float32)
        return self.encode(toks)

    def query_device_inputs(self, texts: list[str]):
        """(query vectors (B, dim) f32 host, identity projection (dim, dim)
        bf16 on the device): queries project on the host, and the fused
        program's embed step applies the identity and renormalizes."""
        if self._eye is None:
            self._eye = torch.eye(self.dim, dtype=torch.bfloat16,
                                  device=self.device)
        cache = self._qvec_cache
        missing = [t for t in texts if t not in cache]
        if missing:
            for t, v in zip(missing, self.encode(missing)):
                if len(cache) >= 8192:
                    cache.pop(next(iter(cache)))
                cache[t] = v
        return np.stack([cache[t] for t in texts]), self._eye
