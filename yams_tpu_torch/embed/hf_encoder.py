"""BERT-architecture encoder on torch + WordPiece tokenizer.

Port of yams_tpu/embed/hf_encoder.py: the HF BERT forward (post-LN blocks,
learned position + token-type embeddings, erf-GELU, mean pooling + L2 norm)
over checkpoints converted by scripts/convert_hf_encoder.py (one flat .npz,
the format the reference's module docstring lists).

- `WordPieceTokenizer` is a copy of the reference's (host Python).
- `bert_forward(state, ids, attn, ...)` is the functional forward on the
  port's state dict (`convert.hf_state_from_npz`: the checkpoint's names
  with "/" turned into "."), with the reference's numerics: LayerNorm in
  f32 with eps 1e-12, dense layers in the compute dtype (so bf16 outputs
  when it is bf16), attention scores from a compute-dtype product cast to
  f32 and divided by sqrt(hd), the -1e9 additive mask, softmax in f32 then
  cast back, the exact (erf) GELU in f32, masked mean pooling and L2 norm
  with 1e-9 floors. `BertEncoder` is the nn.Module holding that state.
- `HFBertEncoder` loads a checkpoint onto a device (the card unless the
  caller asks for the CPU) with the reference's `space_id` (the
  checkpoint's SHA-256), power-of-two buckets, `encode_ids`, `encode` and
  `encode_tokens`.

It departs from the reference in one way: `encode_ids` runs the forward
over slices of at most `ROWS_TOKENS` padded tokens (rows are independent,
so each row's vector is the same), where the reference runs the whole
batch as one program; a 140,000-text batch at T 128 would otherwise hold
55 GB of attention scores. `space_id` hashes the file once and keeps it.
"""

from __future__ import annotations

import hashlib
import math
import pathlib

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

ROWS_TOKENS = 1 << 17   # padded tokens a forward slice holds (encode_ids)


class WordPieceTokenizer:
    """Greedy longest-match WordPiece (BERT uncased semantics)."""

    def __init__(self, vocab: list[str], lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self.lowercase = lowercase
        self.max_chars = max_chars_per_word
        self.cls_id = self.vocab.get("[CLS]", 0)
        self.sep_id = self.vocab.get("[SEP]", 0)
        self.unk_id = self.vocab.get("[UNK]", 0)
        self.pad_id = self.vocab.get("[PAD]", 0)

    def _basic_split(self, text: str) -> list[str]:
        if self.lowercase:
            text = text.lower()
        out: list[str] = []
        word = []
        for ch in text:
            if ch.isalnum():
                word.append(ch)
            else:
                if word:
                    out.append("".join(word))
                    word = []
                if not ch.isspace() and ch.isprintable():
                    out.append(ch)  # punctuation is its own token
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_len: int) -> list[int]:
        ids = [self.cls_id]
        for w in self._basic_split(text):
            ids.extend(self._wordpiece(w))
            if len(ids) >= max_len - 1:
                break
        return ids[: max_len - 1] + [self.sep_id]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """The reference's LayerNorm in f32 (its statistics and eps 1e-12)."""
    return torch.nn.functional.layer_norm(x.float(), scale.shape, scale, bias, eps)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-9)


def compute_dtype_of(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              neg: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) compute-dtype q, k, v and the (B, 1, 1, T) f32 additive
    mask -> (B, T, H * hd): scores from a compute-dtype product cast to f32
    and divided by sqrt(hd), the softmax in f32, cast back for the values."""
    B, T, H, hd = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(hd)
    probs = torch.softmax(scores + neg, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, H * hd)


def bert_layer(P: dict[str, torch.Tensor], pre: str, x: torch.Tensor, neg: torch.Tensor, *,
               num_heads: int, compute_dtype: str = "float32") -> torch.Tensor:
    """One post-LN block: (B, T, D) f32 states -> (B, T, D) f32 states."""
    B, T, D = x.shape
    cdt = compute_dtype_of(compute_dtype)

    def dense(h, prefix):
        return h.to(cdt) @ P[f"{prefix}.kernel"].to(cdt) + P[f"{prefix}.bias"].to(cdt)

    q, k, v = (dense(x, f"{pre}.attn.{n}").reshape(B, T, num_heads, -1) for n in "qkv")
    attn_out = dense(attention(q, k, v, neg), f"{pre}.attn.o")
    x = layer_norm(x + attn_out, P[f"{pre}.attn_ln.scale"], P[f"{pre}.attn_ln.bias"])
    h = torch.nn.functional.gelu(dense(x, f"{pre}.mlp.fc1").float())   # erf GELU, f32
    h = dense(h, f"{pre}.mlp.fc2")
    return layer_norm(x + h, P[f"{pre}.mlp_ln.scale"], P[f"{pre}.mlp_ln.bias"])


def bert_embed(P: dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """Word + position + token-type 0 embeddings, LayerNorm -> (B, T, D) f32."""
    T = ids.shape[1]
    x = (P["embeddings.word"][ids]
         + P["embeddings.position"][:T][None, :, :]
         + P["embeddings.token_type"][0][None, None, :])
    return layer_norm(x, P["embeddings.ln.scale"], P["embeddings.ln.bias"])


def bert_forward(P: dict[str, torch.Tensor], ids: torch.Tensor, attn: torch.Tensor, *,
                 num_layers: int, num_heads: int, compute_dtype: str = "float32",
                 per_token: bool = False) -> torch.Tensor:
    """The BERT forward on a state dict: (B, T) ids and f32 0/1 attention ->
    (B, D) pooled L2 vectors, or with per_token=True the L2-normed
    per-position states (B, T, D) (the ColBERT granularity)."""
    x = bert_embed(P, ids)
    neg = (1.0 - attn)[:, None, None, :] * -1e9
    for i in range(num_layers):
        x = bert_layer(P, f"layer{i}", x, neg, num_heads=num_heads,
                       compute_dtype=compute_dtype)
    if per_token:
        return l2_normalize(x.float())
    w = attn[:, :, None]
    pooled = (x * w).sum(1) / w.sum(1).clamp_min(1e-9)
    return l2_normalize(pooled)


def module_tree(root: nn.Module, state: dict[str, torch.Tensor]) -> nn.Module:
    """Register each "a.b.c" tensor of `state` as a frozen parameter of a
    nested module under `root`, so root.state_dict() has the same keys."""
    for key, t in state.items():
        *path, leaf = key.split(".")
        m = root
        for p in path:
            if p not in m._modules:
                m.add_module(p, nn.Module())
            m = m._modules[p]
        m.register_parameter(leaf, nn.Parameter(t, requires_grad=False))
    return root


class BertEncoder(nn.Module):
    """The BERT forward as an nn.Module over the port's state dict. The
    dense layers' kernels and biases are held in the compute dtype (the
    forward's own cast, made once)."""

    def __init__(self, state: dict[str, torch.Tensor], num_layers: int, num_heads: int,
                 compute_dtype: str = "float32"):
        super().__init__()
        cdt = compute_dtype_of(compute_dtype)
        module_tree(self, {k: v.to(cdt) if k.startswith("layer") and "_ln." not in k else v
                           for k, v in state.items()})
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype

    def forward(self, ids: torch.Tensor, attn: torch.Tensor,
                per_token: bool = False) -> torch.Tensor:
        return bert_forward(dict(self.named_parameters()), ids, attn,
                            num_layers=self.num_layers, num_heads=self.num_heads,
                            compute_dtype=self.compute_dtype, per_token=per_token)


def pad_batch(batches: list[list[int]], T: int, pad_id: int) -> tuple[np.ndarray, np.ndarray]:
    """Token id lists -> (ids (B, T) int64 padded with pad_id, attn (B, T) f32)."""
    ids = np.full((len(batches), T), pad_id, np.int64)
    attn = np.zeros((len(batches), T), np.float32)
    for i, row in enumerate(batches):
        row = row[:T]
        ids[i, : len(row)] = row
        attn[i, : len(row)] = 1.0
    return ids, attn


@torch.inference_mode()
def forward_rows(model: nn.Module, ids: np.ndarray, attn: np.ndarray,
                 device: torch.device, **kw) -> np.ndarray:
    """model(ids, attn) in slices of at most ROWS_TOKENS padded tokens,
    gathered on the host as f32."""
    rows = max(1, ROWS_TOKENS // max(ids.shape[1], 1))
    out = []
    for lo in range(0, len(ids), rows):
        i = torch.from_numpy(ids[lo:lo + rows]).to(device)
        a = torch.from_numpy(attn[lo:lo + rows]).to(device)
        out.append(model(i, a, **kw).float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


class HFBertEncoder:
    """Converted HF BERT checkpoints (MiniLM-class) on one torch device."""

    def __init__(self, checkpoint: str, compute_dtype: str = "bfloat16", *,
                 device: str | torch.device = "cuda"):
        from ..convert import hf_state_from_npz

        self.device = resolve_device(device)
        z = np.load(checkpoint, allow_pickle=False)
        cfg = {k[4:]: int(z[k]) for k in z.files if k.startswith("cfg/")}
        self.dim = cfg["dim"]
        self.num_layers = cfg["layers"]
        self.num_heads = cfg["heads"]
        self.max_len = min(cfg.get("max_len", 256), 256)
        self.intermediate = cfg.get("intermediate", self.dim * 4)
        vocab = [v.decode() if isinstance(v, bytes) else str(v) for v in z["vocab"]]
        self.tokenizer = WordPieceTokenizer(vocab)
        self.compute_dtype = compute_dtype
        self.model = BertEncoder(hf_state_from_npz(checkpoint), self.num_layers,
                                 self.num_heads, compute_dtype).to(self.device)
        self._checkpoint = checkpoint
        self._space_id: str | None = None

    @property
    def space_id(self) -> str:
        if self._space_id is None:
            h = hashlib.sha256(pathlib.Path(self._checkpoint).read_bytes())
            self._space_id = f"hf-bert/d{self.dim}/L{self.num_layers}/{h.hexdigest()[:12]}/v1"
        return self._space_id

    @staticmethod
    def _bucket(n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return b

    def encode_ids(self, batches: list[list[int]]) -> np.ndarray:
        T = min(self._bucket(min(max((len(x) for x in batches), default=1), self.max_len)),
                self.max_len)
        ids, attn = pad_batch(batches, T, self.tokenizer.pad_id)
        if not len(ids):
            return np.zeros((0, self.dim), np.float32)
        return forward_rows(self.model, ids, attn, self.device)

    def encode(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return self.encode_ids([self.tokenizer.encode(t, self.max_len) for t in texts])

    def encode_tokens(self, text: str, max_tokens: int = 32) -> np.ndarray:
        """Contextual per-token embeddings from one forward pass: (n, D)
        L2-normed rows for the first max_tokens non-pad positions."""
        row = self.tokenizer.encode(text, min(max_tokens, self.max_len))
        if not row:
            return np.zeros((0, self.dim), np.float32)
        ids, attn = pad_batch([row], self._bucket(len(row)), self.tokenizer.pad_id)
        out = forward_rows(self.model, ids, attn, self.device, per_token=True)
        return out[0, : len(row)]
