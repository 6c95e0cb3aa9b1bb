"""Synthetic corpus generation for tests and benchmarks.

A copy of yams_tpu/utils/fixtures.py (host NumPy; the port imports nothing
of the JAX package).

Parity: tests/common/fixture_manager.h + TestDataGenerator (topic/keyword/tag
corpus specs, seeded determinism — SURVEY §4 lesson (b)). Generates clustered
topical documents with known relevance structure so retrieval quality has a
ground truth without external datasets.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TOPIC_VOCAB = {
    "systems": ["kernel", "scheduler", "mutex", "thread", "interrupt", "driver",
                "syscall", "buffer", "paging", "preemption", "lock", "daemon"],
    "cooking": ["tomato", "basil", "olive", "pasta", "garlic", "pepper",
                "saute", "oven", "roast", "dough", "broth", "simmer"],
    "ml": ["tensor", "gradient", "matrix", "batch", "layer", "softmax",
           "optimizer", "epoch", "loss", "embedding", "attention", "weights"],
    "music": ["violin", "sonata", "tempo", "chord", "melody", "orchestra",
              "cadence", "fugue", "rhythm", "harmony", "concerto", "scale"],
    "finance": ["ledger", "equity", "dividend", "portfolio", "hedge", "bond",
                "yield", "futures", "margin", "accrual", "audit", "balance"],
}
FILLER = ["the", "a", "of", "and", "to", "with", "for", "is", "are", "on",
          "this", "that", "from", "by", "each", "some", "other", "more"]


@dataclasses.dataclass(slots=True)
class SyntheticDoc:
    name: str
    text: str
    topic: str
    tags: list[str]


@dataclasses.dataclass(slots=True)
class SyntheticCorpus:
    docs: list[SyntheticDoc]
    queries: list[tuple[str, str]]  # (query text, relevant topic)

    def relevant_names(self, topic: str) -> set[str]:
        return {d.name for d in self.docs if d.topic == topic}


class TestDataGenerator:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def corpus(
        self,
        docs_per_topic: int = 25,
        words_per_doc: int = 60,
        topics: list[str] | None = None,
        queries_per_topic: int = 3,
        query_words: int = 4,
        filler_ratio: float = 0.4,
    ) -> SyntheticCorpus:
        topics = topics or list(TOPIC_VOCAB)
        docs: list[SyntheticDoc] = []
        queries: list[tuple[str, str]] = []
        for topic in topics:
            vocab = TOPIC_VOCAB[topic]
            for i in range(docs_per_topic):
                words = []
                for _ in range(words_per_doc):
                    if self.rng.random() < filler_ratio:
                        words.append(FILLER[self.rng.integers(len(FILLER))])
                    else:
                        words.append(vocab[self.rng.integers(len(vocab))])
                docs.append(SyntheticDoc(
                    name=f"{topic}/{i:03d}.txt",
                    text=" ".join(words),
                    topic=topic,
                    tags=[topic],
                ))
            for _ in range(queries_per_topic):
                qwords = self.rng.choice(vocab, size=query_words, replace=False)
                queries.append((" ".join(qwords), topic))
        return SyntheticCorpus(docs=docs, queries=queries)

    def random_bytes(self, n: int) -> bytes:
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def compressible_bytes(self, n: int, repeat: int = 64) -> bytes:
        base = self.random_bytes(max(n // repeat, 1))
        return (base * repeat)[:n]
