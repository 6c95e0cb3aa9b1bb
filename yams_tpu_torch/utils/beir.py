"""BEIR-format retrieval-quality datasets: loader + hard synthetic generator.

Parity: tests/benchmarks/beir_loader.h + retrieval_quality_bench.cpp — the
reference evaluates MRR/nDCG/recall@10 on BEIR scifact (2k docs, 50 queries).
This module loads the same on-disk layout (corpus.jsonl / queries.jsonl /
qrels/<split>.tsv) when a real BEIR dataset is available, and otherwise
synthesizes a deterministic dataset that is *hard by construction*:

- every document mixes exactly two "concepts" plus shared filler vocabulary,
- queries use morphological variants of the concept lemmas that the target
  documents spell differently (defeats unigram BM25 without stemming, while
  char-n-gram hashed embeddings still partially match),
- hard negatives (documents sharing exactly one of the two query concepts)
  outnumber relevant documents several-fold.

A trivially separable corpus (distinct topic vocabularies) saturates every
engine at MRR 1.0 and cannot detect fusion-weight regressions; this one can.

Copied from yams_tpu/utils/beir.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py), so `synthetic_beir` draws the same
`random.Random` stream.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import random


@dataclasses.dataclass
class BeirDataset:
    name: str
    corpus: dict[str, dict]          # doc_id -> {"title": str, "text": str}
    queries: dict[str, str]          # query_id -> text
    qrels: dict[str, dict[str, int]]  # query_id -> {doc_id: grade}

    def relevant(self, qid: str, min_grade: int = 1) -> set[str]:
        return {d for d, g in self.qrels.get(qid, {}).items() if g >= min_grade}


def load_beir(root: str | pathlib.Path, split: str = "test") -> BeirDataset:
    """Load a standard BEIR dataset directory (corpus.jsonl, queries.jsonl,
    qrels/<split>.tsv)."""
    root = pathlib.Path(root)
    corpus: dict[str, dict] = {}
    with open(root / "corpus.jsonl") as f:
        for line in f:
            row = json.loads(line)
            corpus[str(row["_id"])] = {
                "title": row.get("title", ""),
                "text": row.get("text", ""),
            }
    queries: dict[str, str] = {}
    with open(root / "queries.jsonl") as f:
        for line in f:
            row = json.loads(line)
            queries[str(row["_id"])] = row.get("text", "")
    qrels: dict[str, dict[str, int]] = {}
    with open(root / "qrels" / f"{split}.tsv") as f:
        header = f.readline()
        if not header.lower().startswith(("query", "qid")):
            f.seek(0)
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            qid, did, grade = parts[0], parts[1], int(parts[-1])
            qrels.setdefault(qid, {})[did] = grade
    # keep only queries that have judgments
    queries = {q: t for q, t in queries.items() if q in qrels}
    return BeirDataset(root.name, corpus, queries, qrels)


# -- synthetic hard dataset ----------------------------------------------------

_SUFFIXES = ["", "s", "ed", "ing", "ion", "er"]


def _stem(rng: random.Random) -> str:
    consonants = "bcdfghklmnprstvz"
    vowels = "aeiou"
    n = rng.randint(2, 3)
    return "".join(
        rng.choice(consonants) + rng.choice(vowels) for _ in range(n)
    ) + rng.choice(consonants)


def synthetic_beir(
    seed: int = 0,
    n_concepts: int = 32,
    lemmas_per_concept: int = 8,
    n_pairs: int = 64,
    docs_per_pair: int = 12,
    n_queries: int = 50,
    doc_tokens: int = 64,
    query_tokens: int = 7,
) -> BeirDataset:
    """Deterministic BEIR-shaped dataset with hard negatives and
    morphological query/document mismatch."""
    rng = random.Random(seed)
    filler = [_stem(rng) for _ in range(240)]
    concepts = [
        [_stem(rng) for _ in range(lemmas_per_concept)]
        for _ in range(n_concepts)
    ]

    # concept pairs; each pair gets several docs -> relevant sets of ~docs_per_pair
    pairs: list[tuple[int, int]] = []
    seen = set()
    while len(pairs) < n_pairs:
        a, b = rng.sample(range(n_concepts), 2)
        key = (min(a, b), max(a, b))
        if key not in seen:
            seen.add(key)
            pairs.append(key)

    corpus: dict[str, dict] = {}
    pair_docs: dict[tuple[int, int], list[str]] = {p: [] for p in pairs}
    did = 0
    for pair in pairs:
        for _ in range(docs_per_pair):
            doc_id = f"d{did}"
            did += 1
            words = []
            for _ in range(doc_tokens):
                r = rng.random()
                if r < 0.4:
                    words.append(rng.choice(filler))
                else:
                    concept = concepts[pair[0] if r < 0.7 else pair[1]]
                    # documents use the first three surface variants
                    words.append(rng.choice(concept) + rng.choice(_SUFFIXES[:3]))
            corpus[doc_id] = {"title": "", "text": " ".join(words)}
            pair_docs[pair].append(doc_id)

    queries: dict[str, str] = {}
    qrels: dict[str, dict[str, int]] = {}
    for qi in range(n_queries):
        qid = f"q{qi}"
        pair = pairs[qi % len(pairs)]
        words = []
        for t in range(query_tokens):
            if t == query_tokens - 1:
                words.append(rng.choice(filler))
                continue
            concept = concepts[pair[t % 2]]
            # half the query tokens use document-side surface forms (exact
            # lexical match), half use held-out morphological variants that no
            # document spells — BM25 sees partial signal, char-n-gram
            # embeddings recover the rest
            variants = _SUFFIXES[:3] if (t // 2) % 2 == 0 else _SUFFIXES[3:]
            words.append(rng.choice(concept) + rng.choice(variants))
        queries[qid] = " ".join(words)
        qrels[qid] = {d: 2 for d in pair_docs[pair]}
    return BeirDataset(f"synthetic-hard-{seed}", corpus, queries, qrels)
