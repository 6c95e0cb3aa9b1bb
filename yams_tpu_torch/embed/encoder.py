"""Pre-LN transformer sentence encoder (MiniLM-class architecture) on torch.

Port of yams_tpu/embed/encoder.py `NeuralEncoder`: a BERT-style encoder
with mean pooling + L2 norm over hash-based token ids (the simeon token
hash into a 32,768-id space), bucketed to powers of two. Its numerics are
those of the reference's flax modules: bf16 embeddings; pre-LN blocks whose
LayerNorm (eps 1e-6) takes f32 statistics with E[x^2] - E[x]^2 and returns
f32; `MultiHeadDotProductAttention` in bf16 (the query divided by
sqrt(head_dim) rounded to bf16, masked logits at the bf16 minimum, the
softmax in bf16); bf16 dense layers; the tanh-approximate GELU; a bf16
residual stream; the final LayerNorm, mean pooling with a 1e-6 floor and
the L2 norm with 1e-9.

Weights: `load_npz` reads the reference's flat npz ("params/Block_0/..."
names) through `convert.neural_state_from_flax`, over the seeded weights.
Without weights the reference draws its parameters from
`jax.random.PRNGKey(seed)`, which torch cannot reproduce: the port draws
its own from `torch.Generator` seeded with `seed` (flax's initializers'
distributions: truncated normals of variance 1/fan_in, zero biases, unit
LayerNorm scales), and reports the space `neural-torch/...` instead of the
reference's `neural/...`, so an index embedded by one package's random
space is never taken for the other's. With weights loaded it reports the
reference's space id (which, as in the reference, does not depend on which
weights were loaded), so the port reopens the reference's index.

The encoder builds on first use (as the reference's does), so its
attributes may be changed after construction. `encode` runs the forward in
slices of rows (`hf_encoder.forward_rows`), where the reference runs one
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .hf_encoder import l2_normalize, module_tree, pad_batch, forward_rows
from .simeon import _hash_token_cached, tokenize

VOCAB_SIZE = 32768
PAD_ID = 0
CLS_ID = 1


def flax_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """flax nn.LayerNorm with f32 params: f32 statistics, the fast variance
    E[x^2] - E[x]^2 clipped at 0, an f32 result."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mu.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * scale
    return (xf - mu) * mul + bias


def neural_forward(P: dict[str, torch.Tensor], ids: torch.Tensor, attn: torch.Tensor, *,
                   num_layers: int, num_heads: int) -> torch.Tensor:
    """(B, T) ids, f32 0/1 attention -> (B, D) f32 L2-normed pooled vectors."""
    bf = torch.bfloat16
    B, T = ids.shape
    D = P["tok"].shape[1]
    H, hd = num_heads, D // num_heads
    # jnp.sqrt(depth).astype(bf16): the query scale rounded to bf16
    qscale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(bf).to(ids.device)
    big_neg = torch.finfo(bf).min
    keep = (attn > 0)[:, None, None, :]

    def dense(x, prefix):
        return x.to(bf) @ P[f"{prefix}.kernel"].to(bf) + P[f"{prefix}.bias"].to(bf)

    x = P["tok"].to(bf)[ids] + P["pos"].to(bf)[:T][None, :, :]
    for i in range(num_layers):
        pre = f"blocks.{i}"
        h = flax_layer_norm(x, P[f"{pre}.ln1.scale"], P[f"{pre}.ln1.bias"])
        q = dense(h, f"{pre}.attn.q").reshape(B, T, H, hd) / qscale
        k = dense(h, f"{pre}.attn.k").reshape(B, T, H, hd)
        v = dense(h, f"{pre}.attn.v").reshape(B, T, H, hd)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.softmax(w.masked_fill(~keep, big_neg), dim=-1).to(bf)
        ctx = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, D)
        x = x + dense(ctx, f"{pre}.attn.o")
        h = flax_layer_norm(x, P[f"{pre}.ln2.scale"], P[f"{pre}.ln2.bias"])
        h = torch.nn.functional.gelu(dense(h, f"{pre}.fc1"), approximate="tanh")
        x = x + dense(h, f"{pre}.fc2")
    x = flax_layer_norm(x, P["ln_f.scale"], P["ln_f.bias"])
    w = attn[:, :, None]
    pooled = (x * w).sum(1) / w.sum(1).clamp_min(1e-6)
    return l2_normalize(pooled.float())


def seeded_state(dim: int, num_layers: int, mlp_ratio: int, max_len: int,
                 seed: int) -> dict[str, torch.Tensor]:
    """The port's own random weights, drawn on the host from
    torch.Generator(seed) with flax's default initializers' distributions."""
    g = torch.Generator().manual_seed(seed)

    def trunc(shape, fan_in):
        # variance_scaling(1, fan_in, "truncated_normal"): the stddev of a
        # normal truncated at +-2 sigma is 0.8796 sigma
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        t = torch.empty(shape)
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)

    def zeros(*shape):
        return torch.zeros(shape)

    def ones(*shape):
        return torch.ones(shape)

    # flax's embed init takes fan_in over the table's rows (in and out axis 0)
    state = {"tok": trunc((VOCAB_SIZE, dim), VOCAB_SIZE),
             "pos": trunc((max_len, dim), max_len)}
    hidden = dim * mlp_ratio
    for i in range(num_layers):
        pre = f"blocks.{i}"
        state.update({f"{pre}.ln1.scale": ones(dim), f"{pre}.ln1.bias": zeros(dim)})
        for name in ("q", "k", "v", "o"):
            state[f"{pre}.attn.{name}.kernel"] = trunc((dim, dim), dim)
            state[f"{pre}.attn.{name}.bias"] = zeros(dim)
        state.update({f"{pre}.ln2.scale": ones(dim), f"{pre}.ln2.bias": zeros(dim),
                      f"{pre}.fc1.kernel": trunc((dim, hidden), dim),
                      f"{pre}.fc1.bias": zeros(hidden),
                      f"{pre}.fc2.kernel": trunc((hidden, dim), hidden),
                      f"{pre}.fc2.bias": zeros(dim)})
    state.update({"ln_f.scale": ones(dim), "ln_f.bias": zeros(dim)})
    return state


class NeuralEncoderModule(nn.Module):
    """`neural_forward` as an nn.Module over the port's state dict."""

    def __init__(self, state: dict[str, torch.Tensor], num_layers: int, num_heads: int):
        super().__init__()
        module_tree(self, state)
        self.num_layers = num_layers
        self.num_heads = num_heads

    def forward(self, ids: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        return neural_forward(dict(self.named_parameters()), ids, attn,
                              num_layers=self.num_layers, num_heads=self.num_heads)


class NeuralEncoder:
    def __init__(
        self,
        dim: int = 384,
        num_layers: int = 6,
        num_heads: int = 12,
        mlp_ratio: int = 4,
        max_len: int = 256,
        seed: int = 0,
        weights_path: str | None = None,
        *,
        device: str | torch.device = "cuda",
    ):
        self.dim = dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.max_len = max_len
        self.seed = seed
        self.device = resolve_device(device)
        self.model: NeuralEncoderModule | None = None
        self._weights_path = weights_path

    @property
    def space_id(self) -> str:
        space = "neural" if self._weights_path else "neural-torch"
        return f"{space}/d{self.dim}/L{self.num_layers}/seed{self.seed}/v1"

    # -- model -----------------------------------------------------------------
    def _build(self) -> NeuralEncoderModule:
        if self.model is None:
            state = seeded_state(self.dim, self.num_layers, self.mlp_ratio,
                                 self.max_len, self.seed)
            self.model = NeuralEncoderModule(state, self.num_layers, self.num_heads)
            if self._weights_path:
                self.load_npz(self._weights_path)
            self.model.to(self.device)
        return self.model

    def load_npz(self, path: str) -> None:
        """Load a converted checkpoint (flat 'a/b/c' -> array npz, the
        reference's flax names) over the current weights."""
        from ..convert import neural_state_from_flax

        model = self._build()
        tree: dict = {}
        with np.load(path) as data:
            for name in data.files:
                *keys, leaf = name.split("/")
                node = tree
                for k in keys:
                    node = node.setdefault(k, {})
                node[leaf] = data[name]
        params = dict(model.named_parameters())
        with torch.no_grad():
            for key, value in neural_state_from_flax(tree).items():
                params[key].copy_(value)

    # -- tokenization ------------------------------------------------------------
    def _token_ids(self, text: str) -> list[int]:
        ids = [CLS_ID]
        for tok in tokenize(text, self.max_len - 1):
            ids.append(2 + (_hash_token_cached(tok) % (VOCAB_SIZE - 2)))
        return ids[: self.max_len]

    @staticmethod
    def _bucket(n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return b

    def encode(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        model = self._build()
        id_lists = [self._token_ids(t) for t in texts]
        T = self._bucket(min(max(len(x) for x in id_lists), self.max_len))
        ids, attn = pad_batch(id_lists, T, PAD_ID)
        return forward_rows(model, ids, attn, self.device)
