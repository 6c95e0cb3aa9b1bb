"""GraphService: KG construction from documents + query facades.

Parity: src/daemon/components/GraphComponent + EntityGraphService and the
app-level GraphQuery/GraphContext services (SURVEY §2.9). Entity extraction
here is the built-in fallback tier (identifier/keyphrase mining — the
reference's GLiNER plugin being an optional upgrade via the plugin registry).

Copied from yams_tpu/services/graph_service.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import collections
import re

from ..embed.simeon import tokenize

_IDENT_RE = re.compile(r"\b[A-Za-z_][A-Za-z0-9_]{2,}\b")
_CAP_PHRASE_RE = re.compile(r"\b([A-Z][a-z0-9]+(?:\s+[A-Z][a-z0-9]+){0,3})\b")
_STOP = frozenset(
    "the and for with from this that are was were been being have has had not "
    "you your they them their its his her our out but all any can will just "
    "def class import return self none true false if else elif while for in "
    "is of to a an on at by as it be or do we i".split()
)


class GraphService:
    def __init__(self, app):
        self.app = app

    # -- construction -----------------------------------------------------------
    def extract_entities(self, text: str, max_entities: int = 32) -> list[tuple[str, float]]:
        """Built-in entity mining: capitalized phrases + identifiers, blended
        with TextRank keyphrases (Simeon retrieval-util tier); a GLiNER-class
        plugin can replace this via entity_extractor_v1."""
        counts: collections.Counter[str] = collections.Counter()
        for m in _CAP_PHRASE_RE.finditer(text[:100_000]):
            phrase = m.group(1).strip()
            if phrase.lower() not in _STOP and len(phrase) > 3:
                counts[phrase] += 2
        for m in _IDENT_RE.finditer(text[:100_000]):
            w = m.group(0)
            if ("_" in w or any(c.isupper() for c in w[1:])) and w.lower() not in _STOP:
                counts[w] += 1
        total = sum(counts.values()) or 1
        out = {
            ent: min(1.0, 0.3 + cnt / total * 10)
            for ent, cnt in counts.most_common(max_entities)
        }
        # blend in TextRank keyphrases for prose (identifiers dominate code)
        from ..utils.textrank import textrank_keyphrases

        for phrase, score in textrank_keyphrases(text, top_k=8):
            if phrase not in out and len(out) < max_entities:
                out[phrase] = min(1.0, 0.3 + score * 5)
        return sorted(out.items(), key=lambda kv: -kv[1])[:max_entities]

    def index_document(self, doc_id: int, text: str) -> int:
        """Extract entities, upsert KG nodes/aliases, link doc, co-occurrence edges."""
        kg = self.app.kg
        entities = self.extract_entities(text)
        node_ids = []
        for ent, conf in entities:
            key = f"entity:{ent.lower()}"
            nid = kg.upsert_node(key, label=ent, type_="entity")
            kg.add_alias(nid, ent.lower(), source="mined")
            for tok in tokenize(ent):
                if tok not in _STOP and len(tok) > 2:
                    kg.add_alias(nid, tok, source="token")
            kg.link_document(doc_id, nid, ent, conf)
            node_ids.append(nid)
        # co-occurrence edges between the top entities of this doc
        edges = []
        for i, a in enumerate(node_ids[:12]):
            for b in node_ids[i + 1 : 12]:
                if a != b:
                    edges.append((min(a, b), max(a, b), "cooccurs", 1.0))
        if edges:
            kg.add_edges_batch(edges)
        # entity vectors: node labels embedded into the engine's side index
        # (reference: node_embeddings + queryEntityVectors, search_engine.cpp:5504)
        if node_ids:
            self.app.search_engine.add_entity_vectors(
                node_ids, [ent for ent, _ in entities]
            )
        return len(node_ids)

    def index_pending(self, limit: int = 500) -> int:
        """Build KG for docs lacking entities (post-ingest KG stage)."""
        done = 0
        rows = self.app.db.execute(
            """SELECT d.id FROM documents d
               LEFT JOIN doc_entities e ON e.document_id = d.id
               WHERE e.id IS NULL AND d.content_extracted = 1 LIMIT ?""",
            (limit,),
        ).fetchall()
        for (doc_id,) in rows:
            text = self.app.metadata.get_content(doc_id)
            if text:
                self.index_document(doc_id, text)
                done += 1
        return done

    # -- queries ---------------------------------------------------------------------
    def explore(self, alias: str, depth: int = 1, limit: int = 25) -> dict:
        """Alias -> nodes -> neighbors (+docs), the `yams graph` query."""
        kg = self.app.kg
        nodes = kg.resolve_alias(alias, limit=5)
        out = {"query": alias, "nodes": []}
        seen = set()
        for nid in nodes:
            node = kg.get_node(nid)
            if node is None or nid in seen:
                continue
            seen.add(nid)
            neighbors = []
            for nbr, rel, w in kg.neighbors(nid, limit=limit):
                if depth > 1:
                    pass  # single-hop listing; deeper hops via repeated explore
                nnode = kg.get_node(nbr)
                if nnode:
                    neighbors.append(
                        {"label": nnode["label"], "relation": rel, "weight": w}
                    )
            docs = []
            for doc_id, conf in kg.documents_for_node(nid, limit=10):
                try:
                    docs.append(
                        {"path": self.app.metadata.get_document(doc_id).file_path,
                         "confidence": conf}
                    )
                except Exception:
                    pass
            out["nodes"].append(
                {"label": node["label"], "type": node["type"],
                 "neighbors": neighbors, "documents": docs}
            )
        return out

    def related(self, selector: str, limit: int = 20) -> list[dict]:
        """Docs related to a document through shared/linked entities."""
        doc = self.app.documents.get(selector)
        rel = self.app.kg.related_documents(doc.id, hops=2, limit=limit)
        out = []
        for doc_id, support in rel.items():
            try:
                out.append(
                    {"path": self.app.metadata.get_document(doc_id).file_path,
                     "support": support}
                )
            except Exception:
                pass
        return out

    def impact(self, selector: str, hops: int = 2, limit: int = 25) -> list[dict]:
        """Docs transitively reachable from this doc's entities/symbols —
        "what is affected if this changes" (reference GraphScope impact
        queries, ipc_protocol_requests.h GraphExplore family)."""
        doc = self.app.documents.get(selector)
        kg = self.app.kg
        frontier = {nid for nid, _, _ in kg.entities_for_document(doc.id)}
        seen_nodes = set(frontier)
        support: dict[int, float] = {}
        decay = 1.0
        for _ in range(max(hops, 1)):
            nxt: set[int] = set()
            for nid in frontier:
                for doc_id, conf in kg.documents_for_node(nid, limit=50):
                    if doc_id != doc.id:
                        support[doc_id] = support.get(doc_id, 0.0) + conf * decay
                for nbr, _rel, w in kg.neighbors(nid, limit=25):
                    if nbr not in seen_nodes:
                        seen_nodes.add(nbr)
                        nxt.add(nbr)
            frontier = nxt
            decay *= 0.5
            if not frontier:
                break
        out = []
        for doc_id, s in sorted(support.items(), key=lambda kv: -kv[1])[:limit]:
            try:
                out.append({"path": self.app.metadata.get_document(doc_id).file_path,
                            "impact": round(s, 4)})
            except Exception:
                pass
        return out

    def trace(self, from_selector: str, to_selector: str,
              max_hops: int = 6) -> list[str] | None:
        """Shortest entity path connecting two documents (BFS over KG edges);
        None when unconnected within max_hops."""
        kg = self.app.kg
        a = self.app.documents.get(from_selector)
        b = self.app.documents.get(to_selector)
        starts = {nid for nid, _, _ in kg.entities_for_document(a.id)}
        goals = {nid for nid, _, _ in kg.entities_for_document(b.id)}
        if not starts or not goals:
            return None
        hit = starts & goals
        if hit:
            n = kg.get_node(next(iter(hit)))
            return [n["label"]] if n else None
        prev: dict[int, int | None] = {n: None for n in starts}
        frontier = set(starts)
        for _ in range(max_hops):
            nxt: set[int] = set()
            for nid in frontier:
                for nbr, _rel, _w in kg.neighbors(nid, limit=50):
                    if nbr in prev:
                        continue
                    prev[nbr] = nid
                    if nbr in goals:
                        path = [nbr]
                        while prev[path[-1]] is not None:
                            path.append(prev[path[-1]])
                        labels = []
                        for x in reversed(path):
                            node = kg.get_node(x)
                            labels.append(node["label"] if node else str(x))
                        return labels
                    nxt.add(nbr)
            frontier = nxt
            if not frontier:
                break
        return None

    def stats(self) -> dict:
        return {"nodes": self.app.kg.node_count(), "edges": self.app.kg.edge_count()}
