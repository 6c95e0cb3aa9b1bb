"""Knowledge graph store over SQLite.

Copied from yams_tpu/metadata/kg.py: nodes, aliases, edges, doc links and
the generation-keyed read caches the search engine's KG leg reads.

Parity: src/metadata/knowledge_graph_store_sqlite.cpp (kg_nodes/aliases/edges/
doc_entities tables per migration.cpp:867-949) with the query surface the
search engine needs: alias lookup, neighbor expansion, doc<->entity joins.
"""

from __future__ import annotations

import json
import threading
import time

from .db import Database


class KnowledgeGraphStore:
    # serving caches for the per-query KG evidence leg (search runs
    # resolve_alias x 8 tokens + documents_for_node per hit per query):
    # bounded FIFO maps keyed by (arg, limit); any KG write bumps the
    # generation, which lazily clears both (writes are rare vs searches)
    _CACHE_MAX = 65536

    def __init__(self, db: Database):
        self.db = db
        self._alias_cache: dict = {}
        self._docs_cache: dict = {}
        self._gen = 0
        self._cache_gen = 0
        # fill/evict guard: the daemon's search pool calls _cache from
        # several reader threads concurrently with _bump() on the mutator
        # thread; without it two threads racing the cap can both pop the
        # same key (KeyError) and a fill in flight across a _bump can pin a
        # stale value under the new generation
        self._cache_lock = threading.Lock()

    def _bump(self) -> None:
        with self._cache_lock:
            self._gen += 1

    def _cache(self, store: dict, key, fill):
        with self._cache_lock:
            if self._cache_gen != self._gen:
                self._alias_cache.clear()
                self._docs_cache.clear()
                self._cache_gen = self._gen
            gen = self._gen
            hit = store.get(key)
        if hit is not None:
            return hit
        val = fill()
        with self._cache_lock:
            # a write landed while filling: the value may predate it
            if self._gen != gen:
                return val
            if len(store) >= self._CACHE_MAX:
                store.pop(next(iter(store)), None)
            store[key] = val
        return val

    # -- nodes ---------------------------------------------------------------
    def upsert_node(
        self, node_key: str, label: str = "", type_: str = "entity",
        properties: dict | None = None,
    ) -> int:
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                """INSERT INTO kg_nodes (node_key, label, type, properties, created_time)
                   VALUES (?,?,?,?,?)
                   ON CONFLICT(node_key) DO UPDATE SET
                     label=CASE WHEN excluded.label != '' THEN excluded.label ELSE label END""",
                (node_key, label or node_key, type_,
                 json.dumps(properties or {}), time.time()),
            )
            self._bump()
            return self.db.conn.execute(
                "SELECT id FROM kg_nodes WHERE node_key=?", (node_key,)
            ).fetchone()[0]

    def get_node(self, node_id: int) -> dict | None:
        row = self.db.execute("SELECT * FROM kg_nodes WHERE id=?", (node_id,)).fetchone()
        if row is None:
            return None
        return {
            "id": row["id"], "node_key": row["node_key"], "label": row["label"],
            "type": row["type"], "properties": json.loads(row["properties"]),
        }

    def find_node(self, node_key: str) -> int | None:
        row = self.db.execute(
            "SELECT id FROM kg_nodes WHERE node_key=?", (node_key,)
        ).fetchone()
        return row[0] if row else None

    def node_count(self) -> int:
        return self.db.execute("SELECT COUNT(*) FROM kg_nodes").fetchone()[0]

    def edge_count(self) -> int:
        return self.db.execute("SELECT COUNT(*) FROM kg_edges").fetchone()[0]

    # -- aliases -------------------------------------------------------------
    def add_alias(self, node_id: int, alias: str, source: str = "") -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                "INSERT INTO kg_aliases (node_id, alias, source) VALUES (?,?,?)",
                (node_id, alias, source),
            )
        self._bump()

    def resolve_alias(self, alias: str, limit: int = 10) -> list[int]:
        """Exact then prefix alias lookup -> node ids (cached)."""
        def fill():
            rows = self.db.execute(
                "SELECT DISTINCT node_id FROM kg_aliases WHERE alias=? LIMIT ?",
                (alias, limit),
            ).fetchall()
            if not rows:
                rows = self.db.execute(
                    "SELECT DISTINCT node_id FROM kg_aliases"
                    " WHERE alias LIKE ? LIMIT ?",
                    (alias + "%", limit),
                ).fetchall()
            return [r[0] for r in rows]

        return self._cache(self._alias_cache, (alias, limit), fill)

    # -- edges ------------------------------------------------------------------
    def add_edge(
        self, src: int, dst: int, relation: str = "related", weight: float = 1.0,
        properties: dict | None = None,
    ) -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                """INSERT INTO kg_edges (src_node_id, dst_node_id, relation, weight, properties)
                   VALUES (?,?,?,?,?)
                   ON CONFLICT(src_node_id, dst_node_id, relation)
                   DO UPDATE SET weight = MAX(weight, excluded.weight)""",
                (src, dst, relation, weight, json.dumps(properties or {})),
            )
        self._bump()

    def add_edges_batch(self, edges: list[tuple[int, int, str, float]]) -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.executemany(
                """INSERT INTO kg_edges (src_node_id, dst_node_id, relation, weight)
                   VALUES (?,?,?,?)
                   ON CONFLICT(src_node_id, dst_node_id, relation)
                   DO UPDATE SET weight = MAX(weight, excluded.weight)""",
                edges,
            )
        self._bump()

    def neighbors(
        self, node_id: int, relation: str | None = None, limit: int = 100
    ) -> list[tuple[int, str, float]]:
        """Outgoing + incoming neighbors: [(node_id, relation, weight)]."""
        params: dict = {"nid": node_id, "lim": limit}
        rel_clause = ""
        if relation:
            rel_clause = " AND relation=:rel"
            params["rel"] = relation
        rows = self.db.execute(
            f"""SELECT CASE WHEN src_node_id=:nid THEN dst_node_id ELSE src_node_id END,
                       relation, weight
                FROM kg_edges WHERE (src_node_id=:nid OR dst_node_id=:nid){rel_clause}
                ORDER BY weight DESC LIMIT :lim""",
            params,
        ).fetchall()
        return [(r[0], r[1], r[2]) for r in rows]

    # -- document <-> entity links -------------------------------------------------
    def link_document(
        self, doc_id: int, node_id: int, entity_text: str = "", confidence: float = 1.0
    ) -> None:
        with self.db.lock, self.db.conn:
            self.db.conn.execute(
                "INSERT INTO doc_entities (document_id, node_id, entity_text, confidence)"
                " VALUES (?,?,?,?)",
                (doc_id, node_id, entity_text, confidence),
            )
        self._bump()

    def documents_for_node(self, node_id: int, limit: int = 100) -> list[tuple[int, float]]:
        def fill():
            rows = self.db.execute(
                """SELECT document_id, MAX(confidence) FROM doc_entities
                   WHERE node_id=? GROUP BY document_id LIMIT ?""",
                (node_id, limit),
            ).fetchall()
            return [(r[0], r[1]) for r in rows]

        return self._cache(self._docs_cache, (node_id, limit), fill)

    def entities_for_document(self, doc_id: int) -> list[tuple[int, str, float]]:
        rows = self.db.execute(
            "SELECT node_id, entity_text, confidence FROM doc_entities WHERE document_id=?",
            (doc_id,),
        ).fetchall()
        return [(r[0], r[1], r[2]) for r in rows]

    def has_doc_entities(self) -> bool:
        """Cached 'any doc<->entity links exist' probe (generation-
        invalidated like the other serving caches): lets the graph-rerank
        window skip its per-candidate entity joins entirely on corpora that
        never ran entity extraction — the common non-KG deployment. Measured
        at ~32 pointless sqlite queries per search (1.2 ms) before this."""
        def fill():
            return (self.db.execute(
                "SELECT 1 FROM doc_entities LIMIT 1").fetchone() is not None,)

        return self._cache(self._docs_cache, "__has_doc_entities__", fill)[0]

    def entities_for_documents(
        self, doc_ids: list[int],
    ) -> dict[int, list[tuple[int, str, float]]]:
        """Batched entities_for_document: ONE IN-query per <=500-id chunk.
        The graph-rerank candidate window issues this once per query instead
        of one sqlite round trip per candidate doc."""
        out: dict[int, list[tuple[int, str, float]]] = {d: [] for d in doc_ids}
        ids = list(dict.fromkeys(doc_ids))
        for i in range(0, len(ids), 500):
            chunk = ids[i:i + 500]
            ph = ",".join("?" * len(chunk))
            rows = self.db.execute(
                "SELECT document_id, node_id, entity_text, confidence "
                f"FROM doc_entities WHERE document_id IN ({ph})",
                chunk,
            ).fetchall()
            for d, n, t, c in rows:
                out[d].append((n, t, c))
        return out

    def related_documents(
        self, doc_id: int, hops: int = 1, limit: int = 50
    ) -> dict[int, float]:
        """Docs sharing entities with doc_id (optionally via 1-hop KG expansion).

        Returns {doc_id: support} where support accumulates shared-entity
        confidence — the seed signal for graph reranking
        (reference: search_engine.cpp:238-368 reciprocal community support).
        """
        seeds = [n for n, _, _ in self.entities_for_document(doc_id)]
        frontier = set(seeds)
        if hops > 1:
            for n in list(frontier):
                frontier.update(nbr for nbr, _, _ in self.neighbors(n, limit=20))
        support: dict[int, float] = {}
        for node in frontier:
            for other_doc, conf in self.documents_for_node(node, limit=limit):
                if other_doc != doc_id:
                    support[other_doc] = support.get(other_doc, 0.0) + conf
        return dict(sorted(support.items(), key=lambda kv: -kv[1])[:limit])
