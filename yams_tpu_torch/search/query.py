"""Query understanding: intent routing, fuzzy correction, expansion, PRF.

Parity: the reference's query-understanding stack (SURVEY §2.6) —
query_router.cpp (intent/retrieval-mode), symspell fuzzy correction,
sub-phrase + IDF concept extraction (GLiNER fallback tier), and Simeon's
pseudo-relevance-feedback expansion.

Copied from yams_tpu/search/query.py (host code; the port imports nothing
of yams_tpu).
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter

from ..embed.simeon import tokenize


@dataclasses.dataclass(slots=True)
class ParsedQuery:
    """Query with inline qualifiers stripped (reference: query_qualifiers.hpp).

    Supported: tag:x (repeatable), path:GLOB, collection:NAME, type:MODE.
    """

    text: str
    tags: list[str]
    path_glob: str | None
    collection: str | None
    search_type: str | None


_QUALIFIER_RE = re.compile(r"\b(tag|path|collection|type):(\"[^\"]+\"|\S+)")


def parse_qualifiers(query: str) -> ParsedQuery:
    tags: list[str] = []
    path_glob = collection = search_type = None
    def _strip(m):
        nonlocal path_glob, collection, search_type
        key, val = m.group(1), m.group(2).strip('"')
        if key == "tag":
            tags.append(val)
        elif key == "path":
            path_glob = val
        elif key == "collection":
            collection = val
        elif key == "type":
            search_type = val
        return ""

    text = _QUALIFIER_RE.sub(_strip, query).strip()
    text = re.sub(r"\s+", " ", text)
    return ParsedQuery(text, tags, path_glob, collection, search_type)


@dataclasses.dataclass(slots=True)
class RoutingPlan:
    intent: str           # lookup | navigational | conceptual | question
    mode: str             # keyword | hybrid | vector
    corrected_query: str
    expansions: list[str]


_QUESTION_RE = re.compile(
    r"^(who|what|when|where|why|how|which|does|do|is|are|can|should)\b", re.I
)
_PATHISH_RE = re.compile(r"[/\\.]|::")
_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def classify_intent(query: str) -> str:
    """Heuristic intent classes (reference: query_router.cpp:244)."""
    q = query.strip()
    toks = tokenize(q)
    if not toks:
        return "lookup"
    if _QUESTION_RE.match(q) and len(toks) >= 3:
        return "question"
    if _PATHISH_RE.search(q) or (len(toks) <= 2 and all(
        _IDENT_RE.match(t) and ("_" in t or any(c.isupper() for c in q))
        for t in q.split()
    )):
        return "navigational"
    if len(toks) <= 2:
        return "lookup"
    return "conceptual"


def route_mode(intent: str) -> str:
    """Intent -> retrieval mode (intent-adaptive weighting analog)."""
    return {
        "navigational": "keyword",
        "lookup": "hybrid",
        "conceptual": "hybrid",
        "question": "hybrid",
    }[intent]


def intent_weight_multipliers(intent: str) -> tuple[float, float]:
    """(text_mult, vector_mult) per intent — the reference's
    enableIntentAdaptiveWeighting (search_engine_config.h:295, on by
    default): exact-term intents lean lexical, semantic intents lean dense.
    Multipliers ride the traced weight vector, so this never recompiles."""
    return {
        "navigational": (1.3, 0.7),
        "lookup": (1.15, 0.9),
        "conceptual": (0.9, 1.2),
        "question": (0.85, 1.3),
    }.get(intent, (1.0, 1.0))


# -- symspell-style fuzzy correction ---------------------------------------------

def _deletes(word: str, depth: int = 1) -> set[str]:
    out = {word}
    frontier = {word}
    for _ in range(depth):
        nxt = set()
        for w in frontier:
            for i in range(len(w)):
                nxt.add(w[:i] + w[i + 1:])
        out |= nxt
        frontier = nxt
    return out


class FuzzyCorrector:
    """SymSpell-style: precomputed deletes of the vocab, O(1) lookup.

    Parity: src/search/ symspell fuzzy (132 LoC in the reference)."""

    def __init__(self, vocab: dict[str, int], min_len: int = 4, depth: int = 1):
        self.vocab = vocab
        self.min_len = min_len
        self._index: dict[str, str] = {}
        # prefer higher-frequency words on collision (vocab maps term->df or id)
        for word in sorted(vocab, key=lambda w: -vocab.get(w, 0)):
            if len(word) < min_len:
                continue
            for d in _deletes(word, depth):
                self._index.setdefault(d, word)

    def correct(self, token: str) -> str:
        if token in self.vocab or len(token) < self.min_len:
            return token
        for d in _deletes(token, 1):
            hit = self._index.get(d)
            if hit is not None:
                return hit
        return token

    def correct_query(self, query: str) -> str:
        toks = query.split()
        return " ".join(self.correct(t.lower()) if t.isalpha() else t for t in toks)


# -- expansion ---------------------------------------------------------------------

def subphrase_expansions(query: str, max_expansions: int = 4) -> list[str]:
    """Sub-phrase concept extraction (GLiNER-fallback tier):
    bigrams of informative tokens."""
    toks = [t for t in tokenize(query) if len(t) > 2]
    out = []
    for a, b in zip(toks, toks[1:]):
        out.append(f"{a} {b}")
        if len(out) >= max_expansions:
            break
    return out


def prf_expansion(
    query: str,
    top_doc_texts: list[str],
    max_terms: int = 4,
    min_df: int = 2,
    global_df: dict[str, int] | None = None,
    n_docs: int = 0,
) -> list[str]:
    """Pseudo-relevance feedback: informative terms from the top results,
    absent from the query (Simeon PRF analog).

    With corpus statistics (global_df + n_docs), candidates rank by PMI —
    log of feedback-set frequency over corpus frequency (the Simeon
    PMI/concept-mining tier); without, by raw feedback frequency."""
    qset = set(tokenize(query))
    k = max(len(top_doc_texts), 1)
    df: Counter[str] = Counter()
    for text in top_doc_texts:
        df.update(set(tokenize(text, 512)))
    cands = [
        (term, n) for term, n in df.most_common(128)
        if n >= min_df and term not in qset and len(term) > 3
    ]
    if global_df and n_docs > 0:
        import math

        def pmi(term, n):
            g = max(global_df.get(term, n), 1)
            return math.log((n / k) / (g / n_docs))

        cands.sort(key=lambda tn: -pmi(*tn))
    return [t for t, _ in cands[:max_terms]]


def build_routing_plan(query: str, vocab: dict[str, int] | None = None,
                       corrector: "FuzzyCorrector | None" = None) -> RoutingPlan:
    """The per-query plan (reference: buildSearchRoutingPlan,
    search_engine.cpp:1437)."""
    intent = classify_intent(query)
    corrected = query
    if corrector is not None:
        corrected = corrector.correct_query(query)
    return RoutingPlan(
        intent=intent,
        mode=route_mode(intent),
        corrected_query=corrected,
        expansions=subphrase_expansions(query),
    )
