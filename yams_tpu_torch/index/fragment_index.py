"""Fragment-geometry store: per-document SENTENCE embeddings for rerank.

Port of yams_tpu/index/fragment_index.py: a fragment is a coarser token,
so the (slots, F, D) sentence-embedding array reuses the TokenIndex's
storage, device gather and the MaxSim op (ops/maxsim.py); `top_sentences`
(a copy of the reference's host code) picks each doc's most informative
sentences (distinct-token count, bounded length) in document order.
"""

from __future__ import annotations

import re

from .token_index import TokenIndex

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+|\n{2,}|\n(?=[#*\-])")


def top_sentences(text: str, n: int = 6, max_chars: int = 400) -> list[str]:
    """The doc's n most informative sentences (distinct-token count, long
    runs truncated), in document order — lead bias preserved on ties."""
    cands = []
    for i, s in enumerate(_SENT_SPLIT.split(text)):
        s = s.strip()[:max_chars]
        if len(s) < 16:
            continue
        distinct = len({w for w in s.lower().split() if len(w) > 2})
        if distinct >= 3:
            cands.append((distinct, -i, s))
    cands.sort(reverse=True)
    keep = sorted(cands[:n], key=lambda t: -t[1])  # back to doc order
    return [s for _d, _i, s in keep]


class FragmentIndex(TokenIndex):
    """TokenIndex whose rows are sentence embeddings."""

    def set_doc_text(self, slot: int, text: str, provider,
                     n_sentences: int = 6) -> int:
        sents = top_sentences(text, n=min(n_sentences, self.max_tokens))
        if not sents:
            self.remove_doc(slot)
            return 0
        vecs = provider.encode(sents)
        self.set_doc(slot, vecs)
        return len(sents)
