"""Simeon-style model-free hashed embeddings: the host half.

Copied from yams_tpu/embed/simeon.py (`tokenize`, `light_stem`, the hashed
n-gram sketch `sketch_text` and its batch form `sketch_texts`). The batch
sketch runs the port's native C++ sketch library (yams_tpu_torch/native)
when it builds and falls back to the NumPy path otherwise; both give the
same counts. The projection and normalisation, `SimeonEncoder` in the
reference, are the port's SimeonProvider (embed/provider.py).
"""

from __future__ import annotations

import functools
import re

import numpy as np

from ..core.config import EmbeddingConfig

_WORD_RE = re.compile(r"[\w]+", re.UNICODE)

_P = np.uint64(0x100000001B3)  # FNV prime, used as polynomial base
_OFF = np.uint64(0xCBF29CE484222325)
_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def tokenize(text: str, max_tokens: int | None = None) -> list[str]:
    """Lowercase word tokens; '_' and '-' stay inside tokens via \\w + manual '-'.

    Matches the spirit of FTS5 unicode61 tokenchars '_-' (migration.cpp:465-471)
    so the lexical and embedding views agree on token boundaries.
    """
    toks = _WORD_RE.findall(text.lower())
    return toks[:max_tokens] if max_tokens else toks


_STEM_SUFFIXES = (
    "ingly", "edly", "ments", "ings", "ions", "ment", "ing", "ion",
    "ers", "ies", "ed", "es", "er", "ly", "s",
)


def light_stem(token: str, min_stem: int = 3) -> str:
    """One-pass suffix-strip stemmer (Porter step-1 tier).

    Used for query-side morphological expansion against the lexical vocab
    (the reference reaches the same recall through Simeon's subword lexical
    recipes, simeon_lexical_backend.cpp); deliberately conservative — one
    suffix, longest match, and the stem keeps >= min_stem chars."""
    for suf in _STEM_SUFFIXES:
        if token.endswith(suf) and len(token) - len(suf) >= min_stem:
            return token[: len(token) - len(suf)]
    return token


def _mix(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — decorrelates polynomial hashes before bucketing."""
    with np.errstate(over="ignore"):
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return h ^ (h >> np.uint64(31))


def _hash_tokens(tokens: list[str]) -> np.ndarray:
    """FNV-1a over UTF-8 bytes per token -> u64 array."""
    out = np.empty(len(tokens), dtype=np.uint64)
    for i, t in enumerate(tokens):
        h = 0xCBF29CE484222325
        for b in t.encode("utf-8"):
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        out[i] = h
    return out


@functools.lru_cache(maxsize=1 << 16)
def _hash_token_cached(token: str) -> int:
    h = 0xCBF29CE484222325
    for b in token.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _char_ngram_hashes(text: str, n: int) -> np.ndarray:
    """All char n-gram hashes of text, vectorized: polynomial hash over windows."""
    raw = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
    if len(raw) < n:
        return np.empty(0, dtype=np.uint64)
    g = raw.astype(np.uint64)
    with np.errstate(over="ignore"):
        h = np.full(len(raw) - n + 1, _OFF, dtype=np.uint64)
        for j in range(n):
            h = (h * _P) ^ g[j : len(raw) - n + 1 + j]
    return _mix(h)


def _word_ngram_hashes(token_hashes: np.ndarray, n: int) -> np.ndarray:
    if len(token_hashes) < n:
        return np.empty(0, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = np.full(len(token_hashes) - n + 1, _OFF, dtype=np.uint64)
        for j in range(n):
            h = (h * _P) ^ token_hashes[j : len(token_hashes) - n + 1 + j]
    return _mix(h) if n > 1 else _mix(token_hashes.copy())


def sketch_text(text: str, config: EmbeddingConfig) -> np.ndarray:
    """Signed hashed n-gram sketch (float32, shape (sketch_dim,)).

    bucket = h % S; sign = ±1 from a high hash bit; counts are sublinearly
    scaled (log1p) like hashed-TF, so long documents don't dominate.
    """
    S = config.sketch_dim
    hashes: list[np.ndarray] = []
    tokens = tokenize(text, config.max_doc_tokens)
    if tokens:
        th = np.array([_hash_token_cached(t) for t in tokens], dtype=np.uint64)
        for n in config.word_ngrams:
            hashes.append(_word_ngram_hashes(th, n))
        joined = " ".join(tokens)
        for n in config.char_ngrams:
            hashes.append(_char_ngram_hashes(joined, n))
    if not hashes or all(len(h) == 0 for h in hashes):
        return np.zeros(S, dtype=np.float32)
    h = np.concatenate([x for x in hashes if len(x)])
    idx = (h % np.uint64(S)).astype(np.int64)
    sign = np.where((h >> np.uint64(63)) & np.uint64(1), -1.0, 1.0).astype(np.float32)
    counts = np.bincount(idx, weights=sign, minlength=S).astype(np.float32)
    return np.sign(counts) * np.log1p(np.abs(counts))


def sketch_texts(texts: list[str], config: EmbeddingConfig) -> np.ndarray:
    """Batch sketches -> (B, sketch_dim) float32.

    Hot path: the C++ kernel (native/__init__.py:sketch_batch) computes the
    raw signed bucket counts ~100x faster than the per-doc NumPy loop; the
    log1p scaling stays here so both paths are bit-identical (counts are
    exact +-1 sums in f32). Non-ASCII docs fall back per-doc to sketch_text
    (CPython's Unicode tokenization is authoritative for them).
    """
    if not texts:
        return np.zeros((0, config.sketch_dim), dtype=np.float32)
    from ..native import sketch_batch

    got = sketch_batch(texts, config.sketch_dim, config.max_doc_tokens,
                       config.word_ngrams, config.char_ngrams)
    if got is None:
        return np.stack([sketch_text(t, config) for t in texts])
    counts, ok = got
    out = np.sign(counts) * np.log1p(np.abs(counts))
    for i in np.nonzero(ok == 0)[0]:
        out[i] = sketch_text(texts[i], config)
    return out
