"""TextRank keyphrase extraction (Simeon retrieval-util parity).

Graph-based ranking over a word co-occurrence graph: tokens are nodes, edges
connect tokens within a sliding window, and a damped power iteration scores
centrality. Top unigrams are merged into phrases when adjacent in the text.
Pure NumPy — used by GraphService as an upgrade tier over frequency mining.

Copied from yams_tpu/utils/textrank.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import numpy as np

from ..embed.simeon import tokenize

_STOP = frozenset(
    "the a an and or of to in for with on at by from is are was were be been "
    "this that these those it its as if then than so but not no we you they "
    "i he she his her our your their have has had do does did will would can "
    "could should may might about into over under between after before".split()
)


def textrank_keyphrases(
    text: str,
    top_k: int = 10,
    window: int = 4,
    damping: float = 0.85,
    iters: int = 30,
    max_tokens: int = 4096,
) -> list[tuple[str, float]]:
    """[(phrase, score)] ranked by TextRank centrality."""
    tokens = tokenize(text, max_tokens)
    candidates = [t for t in tokens if t not in _STOP and len(t) > 2
                  and not t.isdigit()]
    if not candidates:
        return []
    vocab = {t: i for i, t in enumerate(dict.fromkeys(candidates))}
    n = len(vocab)
    adj = np.zeros((n, n), np.float32)
    # co-occurrence edges over the ORIGINAL token stream (windows span stops)
    positions = [(i, vocab[t]) for i, t in enumerate(tokens) if t in vocab]
    for a in range(len(positions)):
        pa, va = positions[a]
        for b in range(a + 1, len(positions)):
            pb, vb = positions[b]
            if pb - pa > window:
                break
            if va != vb:
                adj[va, vb] += 1.0
                adj[vb, va] += 1.0
    deg = adj.sum(axis=1, keepdims=True)
    deg[deg == 0] = 1.0
    M = adj / deg
    score = np.full(n, 1.0 / n, np.float32)
    for _ in range(iters):
        score = (1 - damping) / n + damping * (M.T @ score)
    by_token = {t: float(score[i]) for t, i in vocab.items()}

    # merge adjacent top tokens into phrases
    top_tokens = {t for t, _ in
                  sorted(by_token.items(), key=lambda kv: -kv[1])[: top_k * 3]}
    phrases: dict[str, float] = {}
    i = 0
    while i < len(tokens):
        if tokens[i] in top_tokens:
            j = i
            while j + 1 < len(tokens) and tokens[j + 1] in top_tokens:
                j += 1
            phrase = " ".join(tokens[i : j + 1])
            val = sum(by_token.get(t, 0.0) for t in tokens[i : j + 1])
            phrases[phrase] = max(phrases.get(phrase, 0.0), val)
            i = j + 1
        else:
            i += 1
    return sorted(phrases.items(), key=lambda kv: -kv[1])[:top_k]
