"""A synthetic knowledge graph over a corpus, written with the graph
service's ingest calls (services/graph_service.py index_document): the KG
that `chip_smoke.py` serves on the card and the KG tests build on the CPU.

`kg_graph` draws the entities and links from a seed; `build_kg` writes them
through any KnowledgeGraphStore (the port's or the reference's);
`one_transaction` gives a store whose calls, each a transaction of its own
in the service, join one transaction, for a bulk load."""

from __future__ import annotations

import contextlib
import types

import numpy as np

from ..metadata import KnowledgeGraphStore


def kg_graph(docs, seed: int, n_nodes: int = 16_384):
    """The entities the graph service would find in `docs` ((doc_id, body,
    title) triples): n_nodes distinct labels of 1-3 consecutive words, each
    taken from a random document (so of the corpus' own vocabulary), and
    each document linked to 1-5 of the labels that occur in its text, drawn
    by zipf rank in node order, with confidence in [0.4, 1.0]. -> (labels,
    links: [(doc_id, [(node index, confidence), ...])])."""
    rng = np.random.default_rng(seed)
    toks = [(title + " " + body.rstrip(".")).split() for _, body, title in docs]
    node_of: dict[tuple, int] = {}      # label words -> node index
    while len(node_of) < n_nodes:
        t = toks[int(rng.integers(len(toks)))]
        n = int(rng.integers(1, 4))
        p = int(rng.integers(max(len(t) - n + 1, 1)))
        node_of.setdefault(tuple(t[p:p + n]), len(node_of))
    labels = [" ".join(words) for words in node_of]
    counts = rng.integers(1, 6, len(docs))
    ranks = rng.zipf(1.5, size=int(counts.sum())).tolist()
    confs = rng.uniform(0.4, 1.0, size=len(ranks)).tolist()
    links, p = [], 0
    for (doc_id, _, _), t, c in zip(docs, toks, counts.tolist()):
        grams = set(zip(t)) | set(zip(t, t[1:])) | set(zip(t, t[1:], t[2:]))
        found = sorted(node_of[g] for g in grams if g in node_of)
        ents: dict[int, float] = {}
        for r, conf in zip(ranks[p:p + c], confs[p:p + c]):
            if r <= len(found):
                ents.setdefault(found[r - 1], conf)
        links.append((doc_id, list(ents.items())))
        p += c
    return labels, links


def build_kg(kg, labels, links) -> tuple[list[int], int]:
    """The graph service's ingest calls: a node per label with its
    lowercased label and its tokens of more than 2 characters as aliases,
    each document linked to its entities, co-occurrence edges among a
    document's first 12 entities. -> (node ids in label order, store
    calls made)."""
    from ..embed.simeon import tokenize

    nodes, calls = [], 0
    for label in labels:
        nid = kg.upsert_node(f"entity:{label.lower()}", label=label, type_="entity")
        kg.add_alias(nid, label.lower(), source="mined")
        calls += 2
        for tok in tokenize(label):
            if len(tok) > 2:
                kg.add_alias(nid, tok, source="token")
                calls += 1
        nodes.append(nid)
    for doc_id, ents in links:
        ids = [nodes[e] for e, _ in ents]
        for (e, conf), nid in zip(ents, ids):
            kg.link_document(doc_id, nid, labels[e], conf)
        calls += len(ents)
        edges = [(min(a, b), max(a, b), "cooccurs", 1.0)
                 for i, a in enumerate(ids[:12]) for b in ids[i + 1:12] if a != b]
        if edges:
            kg.add_edges_batch(edges)
            calls += 1
    return nodes, calls


class _Joined:
    """A connection front whose `with` blocks neither commit nor roll back."""

    def __init__(self, conn):
        self._conn = conn

    def __enter__(self):
        return self._conn

    def __exit__(self, *exc):
        return False

    def __getattr__(self, name):
        return getattr(self._conn, name)


@contextlib.contextmanager
def one_transaction(db):
    """A KnowledgeGraphStore over `db` whose calls run unchanged but join
    one transaction, committed when the block ends (rolled back if it
    raises)."""
    front = types.SimpleNamespace(lock=db.lock, conn=_Joined(db.conn), execute=db.execute)
    with db.lock, db.conn:
        yield KnowledgeGraphStore(front)
