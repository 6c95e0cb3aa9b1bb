"""Neural NER: a GLiNER-class label-conditioned span tagger on torch.

Port of yams_tpu/embed/ner.py. The host half (`word_tokenize`,
`_ngram_ids`, `_case_feats`, `featurize`, `identifier_shape`,
`ambiguous_shape`, `NerConfig`) is the reference's code, line for line
(tests/test_torch_host_copies.py). The flax `Encoder` and `Tagger` become
nn.Modules on an explicit device (the card unless the caller asks for the
CPU) whose parameters carry the flax tree's own names and shapes
(`encoder.attn0.query.kernel` (dm, heads, dm/heads), ...), so
`convert.ner_state_from_flax` only flattens the tree. The numerics are
flax's defaults: LayerNorm with eps 1e-6 and the fast variance E[x^2] -
E[x]^2, the tanh GELU, `MultiHeadDotProductAttention` dividing the query
by sqrt(head_dim), masked logits at the f32 minimum and an f32 softmax;
padded query rows still attend to the valid keys.

It departs from the reference in these ways only:

- `NerModel(cfg, seed, device="cuda")`: without weights the reference
  draws its parameters from `jax.random.PRNGKey(seed)`, which torch cannot
  reproduce; the port draws its own from a torch generator seeded with
  `seed` (flax's initializers' distributions).
- The label names go through the encoder once per set of weights (they do
  not depend on the window); the reference runs them in every forward. The
  values are the same.
- `load` reads the pickle with an unpickler that admits only
  `numpy.ndarray`, `numpy.dtype` and numpy's `_reconstruct`, so loading a
  checkpoint runs no other code and needs no flax. `save` writes the
  reference's format (the flax tree of NumPy arrays).
- `fit` (training, optax in the reference) is not ported: ROADMAP queue 1
  item 8.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import pickle
import re

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .encoder import flax_layer_norm

_WORD_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|\d+|[^\sA-Za-z0-9_]")
_HASH_BUCKETS = 4096
_NGRAMS_PER_TOKEN = 8
_CASE_FEATS = 6


def word_tokenize(text: str) -> list[tuple[str, int]]:
    """(token, char_offset) pairs."""
    return [(m.group(0), m.start()) for m in _WORD_RE.finditer(text)]


def _ngram_ids(token: str) -> np.ndarray:
    """Up to _NGRAMS_PER_TOKEN hashed char-trigram ids (padded with 0;
    bucket 0 is reserved as padding)."""
    s = f"<{token.lower()}>"
    ids = []
    for i in range(len(s) - 2):
        h = 2166136261
        for ch in s[i : i + 3]:
            h = ((h ^ ord(ch)) * 16777619) & 0xFFFFFFFF
        ids.append(1 + h % (_HASH_BUCKETS - 1))
        if len(ids) == _NGRAMS_PER_TOKEN:
            break
    while len(ids) < _NGRAMS_PER_TOKEN:
        ids.append(0)
    return np.array(ids, dtype=np.int32)


def _case_feats(token: str) -> np.ndarray:
    return np.array(
        [
            token[:1].isupper(),
            token.isupper() and len(token) > 1,
            any(c.isdigit() for c in token),
            "_" in token,
            any(c.isupper() for c in token[1:]),  # camelCase interior
            token.islower(),
        ],
        dtype=np.float32,
    )


def featurize(tokens: list[str], length: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad/truncate to `length` -> (ngram_ids (L,G), case (L,F), mask (L,))."""
    L = length
    ng = np.zeros((L, _NGRAMS_PER_TOKEN), np.int32)
    cf = np.zeros((L, _CASE_FEATS), np.float32)
    mask = np.zeros(L, np.float32)
    for i, tok in enumerate(tokens[:L]):
        ng[i] = _ngram_ids(tok)
        cf[i] = _case_feats(tok)
        mask[i] = 1.0
    return ng, cf, mask


def identifier_shape(tok: str) -> bool:
    """Unambiguous code-identifier shape: snake_case, dotted.path, or an
    interior capital with lowercase present (camelCase/CamelCase). Shape IS
    the definition of this entity type, so these labels are rule-exact —
    the shared gold for real-text training (scripts/train_ner_default.py)
    and eval (scripts/eval_ner_realtext.py)."""
    if "_" in tok or "." in tok:
        parts = re.split(r"[._]", tok)
        return all(p.isidentifier() or p == "" for p in parts) and any(parts)
    return (any(c.isupper() for c in tok[1:])
            and any(c.islower() for c in tok)
            and tok.isidentifier())


def ambiguous_shape(tok: str) -> bool:
    """Capitalized ordinary word or ALLCAPS acronym: entity-hood is not
    decidable from shape — excluded from real-text scoring."""
    if tok.isupper() and len(tok) > 1:
        return True
    return tok[:1].isupper() and tok[1:].islower()


@dataclasses.dataclass
class NerConfig:
    dm: int = 64
    heads: int = 4
    layers: int = 2
    window: int = 64
    labels: tuple[str, ...] = ("entity",)


# -- the flax modules' parameters, under their flax names ------------------------
class _Dense(nn.Module):
    """flax Dense / DenseGeneral: `kernel` (in..., out...) and `bias`."""

    def __init__(self, kernel_shape: tuple[int, ...], bias_shape: tuple[int, ...]):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_shape))
        self.bias = nn.Parameter(torch.empty(bias_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., in) -> (..., out): the flax Dense's dot, then its bias."""
        return x @ self.kernel + self.bias


class _Embed(nn.Module):
    def __init__(self, rows: int, dm: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(rows, dm))


class _LayerNorm(nn.Module):
    def __init__(self, dm: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dm))
        self.bias = nn.Parameter(torch.zeros(dm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_layer_norm(x, self.scale, self.bias)


class _Attention(nn.Module):
    """flax MultiHeadDotProductAttention (self-attention, no dropout)."""

    def __init__(self, dm: int, heads: int):
        super().__init__()
        hd = dm // heads
        self.heads, self.head_dim = heads, hd
        self.query = _Dense((dm, heads, hd), (heads, hd))
        self.key = _Dense((dm, heads, hd), (heads, hd))
        self.value = _Dense((dm, heads, hd), (heads, hd))
        self.out = _Dense((heads, hd, dm), (dm,))

    def _project(self, x: torch.Tensor, d: _Dense) -> torch.Tensor:
        # DenseGeneral over the last axis: (..., L, dm) -> (..., L, H, hd)
        y = x @ d.kernel.reshape(d.kernel.shape[0], -1)
        return y.unflatten(-1, (self.heads, self.head_dim)) + d.bias

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        q = self._project(x, self.query) / math.sqrt(self.head_dim)
        k = self._project(x, self.key)
        v = self._project(x, self.value)
        logits = torch.einsum("...qhd,...khd->...hqk", q, k)
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
        w = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("...hqk,...khd->...qhd", w, v)
        o = self.out.kernel
        return ctx.flatten(-2) @ o.reshape(-1, o.shape[-1]) + self.out.bias


class Encoder(nn.Module):
    """Hashed-subword transformer encoder: (..., L, G) n-gram ids, (..., L, F)
    case features, (..., L) mask -> (..., L, dm)."""

    def __init__(self, cfg: NerConfig):
        super().__init__()
        dm = cfg.dm
        self.layers = cfg.layers
        self.subword = _Embed(_HASH_BUCKETS, dm)
        self.case = _Dense((_CASE_FEATS, dm), (dm,))
        self.pos = _Embed(cfg.window, dm)
        for i in range(cfg.layers):
            setattr(self, f"ln_a{i}", _LayerNorm(dm))
            setattr(self, f"attn{i}", _Attention(dm, cfg.heads))
            setattr(self, f"ln_m{i}", _LayerNorm(dm))
            setattr(self, f"mlp1_{i}", _Dense((dm, 2 * dm), (2 * dm,)))
            setattr(self, f"mlp2_{i}", _Dense((2 * dm, dm), (dm,)))
        self.ln_out = _LayerNorm(dm)

    def forward(self, ngram_ids: torch.Tensor, case: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        emb = self.subword.embedding[ngram_ids]                 # (..., L, G, dm)
        ngmask = (ngram_ids > 0).to(torch.float32)[..., None]
        x = (emb * ngmask).sum(-2) / ngmask.sum(-2).clamp_min(1.0)
        x = x + self.case(case)
        L = ngram_ids.shape[-2]
        x = x + self.pos.embedding[torch.arange(L, device=ngram_ids.device)]
        keep = (mask > 0)[..., None, None, :]
        for i in range(self.layers):
            h = getattr(self, f"ln_a{i}")(x)
            x = x + getattr(self, f"attn{i}")(h, keep)
            h = getattr(self, f"ln_m{i}")(x)
            h = nn.functional.gelu(getattr(self, f"mlp1_{i}")(h), approximate="tanh")
            x = x + getattr(self, f"mlp2_{i}")(h)
        return self.ln_out(x)


class Tagger(nn.Module):
    """BIO logits conditioned on encoded label-name vectors, ordered
    [O, B_0..B_K-1, I_0..I_K-1]."""

    def __init__(self, cfg: NerConfig):
        super().__init__()
        dm = cfg.dm
        self.encoder = Encoder(cfg)
        self.to_begin = _Dense((dm, dm), (dm,))
        self.to_inside = _Dense((dm, dm), (dm,))
        self.o_bias = _Dense((dm, 1), (1,))
        self.scale = float(1.0 / np.sqrt(dm))

    def label_vectors(self, label_ng: torch.Tensor, label_case: torch.Tensor):
        """(K, Lw, G), (K, Lw, F) -> the begin and inside vectors (K, dm):
        each label name rides through the same encoder, unmasked."""
        lab_mask = torch.ones(label_ng.shape[:-1], dtype=torch.float32,
                              device=label_ng.device)
        lab = self.encoder(label_ng, label_case, lab_mask).mean(-2)
        return self.to_begin(lab), self.to_inside(lab)

    def score(self, x: torch.Tensor, lab_b: torch.Tensor, lab_i: torch.Tensor):
        lb = torch.einsum("...ld,kd->...lk", x, lab_b) * self.scale
        li = torch.einsum("...ld,kd->...lk", x, lab_i) * self.scale
        return torch.cat([self.o_bias(x), lb, li], dim=-1)

    def forward(self, ngram_ids, case, mask, label_ng, label_case) -> torch.Tensor:
        return self.score(self.encoder(ngram_ids, case, mask),
                          *self.label_vectors(label_ng, label_case))


def seeded_state(cfg: NerConfig, seed: int) -> dict[str, torch.Tensor]:
    """The port's own random weights, drawn on the host from
    torch.Generator(seed) with flax's default initializers' distributions:
    truncated normals of variance 1/fan_in for the kernels, normals of
    variance 1/rows for the embeddings, zero biases, unit LayerNorm scales."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, p in Tagger(cfg).state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            # attention's `out` kernel (H, hd, dm) contracts its first two axes
            fan_in = p.shape[0] * (p.shape[1] if name.endswith("out.kernel") else 1)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            t = torch.empty(p.shape)
            state[name] = nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)
        elif leaf == "embedding":
            state[name] = torch.randn(p.shape, generator=g) / math.sqrt(p.shape[0])
        elif leaf == "scale":
            state[name] = torch.ones(p.shape)
        else:
            state[name] = torch.zeros(p.shape)
    return state


class _ArrayUnpickler(pickle.Unpickler):
    """Builds the checkpoint's dicts, tuples and NumPy arrays; refuses every
    other global."""

    def find_class(self, module, name):
        if module == "numpy" and name in ("ndarray", "dtype"):
            return getattr(np, name)
        if name == "_reconstruct" and module in ("numpy._core.multiarray",
                                                 "numpy.core.multiarray"):
            try:       # NumPy 2 names its core numpy._core; NumPy 1 numpy.core
                return importlib.import_module("numpy._core.multiarray")._reconstruct
            except ImportError:
                return importlib.import_module("numpy.core.multiarray")._reconstruct
        raise pickle.UnpicklingError(f"NER checkpoint names {module}.{name}")


class NerModel:
    """Predict wrapper: one window a forward, as in the reference."""

    def __init__(self, cfg: NerConfig | None = None, seed: int = 0, *,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or NerConfig()
        self.device = resolve_device(device)
        self.model = Tagger(self.cfg)
        self.model.load_state_dict(seeded_state(self.cfg, seed))
        self.model.to(self.device).eval()
        self._label_feats()
        self._labels: tuple[torch.Tensor, torch.Tensor] | None = None

    def _label_feats(self) -> None:
        # each label name as a mini window of its words (>=1 token)
        Lw = 4
        ngs, cfs = [], []
        for lab in self.cfg.labels:
            toks = [t for t, _ in word_tokenize(lab)] or [lab]
            ng, cf, _ = featurize(toks, Lw)
            ngs.append(ng)
            cfs.append(cf)
        self._lab_ng = torch.from_numpy(np.stack(ngs)).to(self.device)
        self._lab_cf = torch.from_numpy(np.stack(cfs)).to(self.device)

    @property
    def num_tags(self) -> int:
        return 1 + 2 * len(self.cfg.labels)

    def load_params(self, params) -> None:
        """Install a flax parameter tree (NumPy leaves, with or without its
        "params" level)."""
        from ..convert import ner_state_from_flax

        self.model.load_state_dict(ner_state_from_flax(params))
        self._labels = None

    def params(self) -> dict:
        """The weights as the reference's flax tree of NumPy arrays."""
        from ..convert import ner_flax_from_state

        return ner_flax_from_state(self.model.state_dict())

    # -- training ---------------------------------------------------------------
    def fit(self, examples, steps: int = 300, lr: float = 3e-3,
            batch: int = 16, seed: int = 0) -> float:
        raise NotImplementedError(
            "NerModel.fit (training) is not ported: ROADMAP queue 1 item 8")

    # -- inference --------------------------------------------------------------
    @torch.inference_mode()
    def logits(self, ngram_ids: np.ndarray, case: np.ndarray,
               mask: np.ndarray) -> torch.Tensor:
        """Featurized windows (B, L, G), (B, L, F), (B, L) -> f32 logits
        (B, L, num_tags) on the model's device."""
        if self._labels is None:
            self._labels = self.model.label_vectors(self._lab_ng, self._lab_cf)
        dev = self.device
        x = self.model.encoder(torch.from_numpy(ngram_ids).to(dev),
                               torch.from_numpy(case).to(dev),
                               torch.from_numpy(mask).to(dev))
        return self.model.score(x, *self._labels)

    def tag(self, tokens: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (tag ids (n,), confidence (n,)) for one window of tokens."""
        ng, cf, mask = featurize(tokens, self.cfg.window)
        with torch.inference_mode():
            probs = torch.softmax(self.logits(ng[None], cf[None], mask[None])[0], dim=-1)
        probs = probs.cpu().numpy()
        n = min(len(tokens), self.cfg.window)
        ids = probs[:n].argmax(-1)
        return ids, probs[np.arange(n), ids]

    def extract(self, text: str, min_conf: float = 0.5) -> list[tuple[str, str, float]]:
        """-> [(entity_text, label, confidence)], windowed over long inputs."""
        toks = word_tokenize(text)
        K = len(self.cfg.labels)
        out: list[tuple[str, str, float]] = []
        W = self.cfg.window
        for w0 in range(0, len(toks), W):
            wtoks = toks[w0 : w0 + W]
            ids, conf = self.tag([t for t, _ in wtoks])
            i = 0
            while i < len(ids):
                t = int(ids[i])
                if 1 <= t <= K:  # B_k
                    k, j, cs = t - 1, i + 1, [float(conf[i])]
                    while j < len(ids) and int(ids[j]) == 1 + K + k:
                        cs.append(float(conf[j]))
                        j += 1
                    start = wtoks[i][1]
                    end = wtoks[j - 1][1] + len(wtoks[j - 1][0])
                    c = float(np.mean(cs))
                    if c >= min_conf:
                        out.append((text[start:end], self.cfg.labels[k], c))
                    i = j
                else:
                    i += 1
        return out

    # -- persistence ------------------------------------------------------------
    def save(self, path) -> None:
        with open(path, "wb") as f:
            pickle.dump({"cfg": dataclasses.asdict(self.cfg), "params": self.params()}, f)

    @classmethod
    def load(cls, path, *, device: str | torch.device = "cuda") -> "NerModel":
        with open(path, "rb") as f:
            blob = _ArrayUnpickler(f).load()
        cfg = NerConfig(**{**blob["cfg"],
                           "labels": tuple(blob["cfg"]["labels"])})
        m = cls(cfg, device=device)
        m.load_params(blob["params"])
        return m


class NeuralEntityExtractor:
    """entity_extractor_v1 implementation backed by NerModel (the GLiNER
    plugin slot: plugins/spec.py IFACE_ENTITY_EXTRACTOR)."""

    def __init__(self, model: NerModel):
        self.model = model

    def extract_entities(self, text: str) -> list[tuple[str, str, float]]:
        return self.model.extract(text)
