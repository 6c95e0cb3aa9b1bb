"""Embedding provider registry + providers on torch.

Port of yams_tpu/embed/provider.py. Every provider exposes `dim`,
`space_id`, `encode(texts) -> (B, dim)` f32 L2-normalized (host NumPy) and
`query_device_inputs(texts) -> (vectors (B, dim) f32 host, projection
(dim, dim) bf16 on the provider's device)`: the dense providers (mock,
neural, hf) give their final vectors and an identity projection, as the
simeon provider does for its host-projected queries. Each provider takes a
`device` (the card unless the caller asks for the CPU); `create_provider`
passes it through.

- `MockProvider`: deterministic vectors seeded by a digest of the text
  (host NumPy, the reference's code).
- `NeuralProvider`: the port's `embed.encoder.NeuralEncoder`.
- `HFProvider`: the port's `embed.hf_encoder.HFBertEncoder`; the default
  checkpoint is the repository's `yams_tpu/embed/checkpoints/
  realtext_bert_d192.npz`, read by path as a data file.
- `register_provider`, `create_provider`, `list_providers`: the registry.
  `unregister_provider` is the port's own: the plugin manager removes the
  provider of a plugin it unloads (the reference never removes one, so a
  model of an unloaded plugin stays creatable).

`SimeonProvider` is the port of the reference's with the pieces of
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

import hashlib
import pathlib
from typing import Callable

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


def _identity(dim: int, device: torch.device) -> torch.Tensor:
    return torch.eye(dim, dtype=torch.bfloat16, device=device)


class MockProvider:
    """Deterministic fake embeddings: vectors seeded from a digest of the
    text, so equal text -> equal vector and similarity structure is random."""

    name = "mock"

    def __init__(self, dim: int = 384, *, device: str | torch.device = "cuda"):
        self._dim = dim
        self.device = resolve_device(device)

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def space_id(self) -> str:
        return f"mock/d{self._dim}/v1"

    def encode(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self._dim), np.float32)
        for i, t in enumerate(texts):
            seed = int.from_bytes(
                hashlib.sha256(t.encode()).digest()[:8], "little"
            )
            rng = np.random.default_rng(seed)
            v = rng.standard_normal(self._dim).astype(np.float32)
            out[i] = v / max(np.linalg.norm(v), 1e-9)
        return out

    def query_device_inputs(self, texts: list[str]):
        return self.encode(texts), _identity(self._dim, self.device)


class NeuralProvider:
    """The pre-LN transformer encoder of embed.encoder: with converted
    weights a real sentence space, else the port's seeded random one."""

    name = "neural"

    def __init__(self, dim: int = 384, weights_path: str | None = None,
                 max_len: int = 256, *, device: str | torch.device = "cuda"):
        from .encoder import NeuralEncoder

        self.encoder = NeuralEncoder(dim=dim, weights_path=weights_path,
                                     max_len=max_len, device=device)
        self.device = self.encoder.device

    @property
    def dim(self) -> int:
        return self.encoder.dim

    @property
    def space_id(self) -> str:
        return self.encoder.space_id

    def encode(self, texts: list[str]) -> np.ndarray:
        return self.encoder.encode(texts)

    def query_device_inputs(self, texts: list[str]):
        return self.encode(texts), _identity(self.dim, self.device)


# the repository's trained real-text BERT checkpoint (a data file, read by path)
DEFAULT_HF_CHECKPOINT = (pathlib.Path(__file__).resolve().parents[2] / "yams_tpu" / "embed"
                         / "checkpoints" / "realtext_bert_d192.npz")


class HFProvider:
    """Converted HF BERT checkpoints (MiniLM-class) through the BERT forward
    of embed.hf_encoder; `checkpoint` is an .npz from
    scripts/convert_hf_encoder.py or an in-repo trained one."""

    name = "hf"

    def __init__(self, checkpoint: str = "", compute_dtype: str = "bfloat16", *,
                 device: str | torch.device = "cuda"):
        from .hf_encoder import HFBertEncoder

        self.encoder = HFBertEncoder(checkpoint or str(DEFAULT_HF_CHECKPOINT),
                                     compute_dtype=compute_dtype, device=device)
        self.device = self.encoder.device

    @property
    def dim(self) -> int:
        return self.encoder.dim

    @property
    def space_id(self) -> str:
        return self.encoder.space_id

    def encode(self, texts: list[str]) -> np.ndarray:
        return self.encoder.encode(texts)

    def encode_tokens(self, text: str, max_tokens: int = 32) -> np.ndarray:
        """Contextual per-token embeddings from one forward pass (the
        ColBERT granularity)."""
        return self.encoder.encode_tokens(text, max_tokens=max_tokens)

    def query_device_inputs(self, texts: list[str]):
        return self.encode(texts), _identity(self.dim, self.device)


_REGISTRY: dict[str, Callable] = {
    "simeon": SimeonProvider,
    "mock": MockProvider,
    "neural": NeuralProvider,
    "hf": HFProvider,
}


def register_provider(name: str, factory: Callable) -> None:
    _REGISTRY[name] = factory


def unregister_provider(name: str, factory: Callable | None = None) -> bool:
    """Remove `name` from the registry; with `factory`, only while `name`
    still maps to that factory. True if it was removed."""
    if name not in _REGISTRY or (factory is not None and _REGISTRY[name] is not factory):
        return False
    del _REGISTRY[name]
    return True


def create_provider(name: str, **kw):
    try:
        return _REGISTRY[name](**kw)
    except KeyError:
        raise ValueError(f"unknown embedding provider: {name!r}; "
                         f"known: {sorted(_REGISTRY)}")


def list_providers() -> list[str]:
    return sorted(_REGISTRY)
