"""SearchService: request normalization + routing (hybrid vs FTS-only vs fuzzy).

Parity: src/app/services/search_service.cpp:927-965,1829-1937 — routes to the
device hybrid engine for "hybrid"/"semantic"/"vector"/"keyword", falls back to
SQLite FTS5 for "fts", applies tag/path filters as device-side candidate
pushdown (the reference filters post-fusion; pushdown dominates it).

Copied from yams_tpu/services/search_service.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import threading
import time


@dataclasses.dataclass(slots=True)
class SearchHit:
    document_id: int
    score: float
    path: str = ""
    name: str = ""
    title: str = ""
    snippet: str = ""
    text_score: float = 0.0
    vector_score: float = 0.0
    kg_score: float = 0.0
    hash: str = ""


@dataclasses.dataclass(slots=True)
class SearchResponse:
    hits: list[SearchHit]
    total: int
    query: str
    type: str
    duration_ms: float


class SearchService:
    # path -> frozenset of directory-segment tokens (path-tree evidence leg);
    # bounded FIFO — paths are immutable keys so entries never go stale
    SEG_CACHE_MAX = 65536

    def __init__(self, app):
        self.app = app
        self._seg_cache: dict[str, frozenset] = {}
        self._filter_cache: dict[tuple, tuple[int, set[int] | None]] = {}
        self._snippet_cache: dict[tuple, tuple[int, str]] = {}
        # concurrent reader threads race the FIFO cap; guard fill/evict
        self._seg_lock = threading.Lock()

    def _seg_tokens(self, path: str) -> frozenset:
        toks = self._seg_cache.get(path)
        if toks is None:
            from ..embed.simeon import tokenize as _tok

            segs = [s for s in path.lower().split("/") if s]
            toks = frozenset(t for s in segs[:-1] for t in _tok(s))
            with self._seg_lock:
                if len(self._seg_cache) >= self.SEG_CACHE_MAX:
                    self._seg_cache.pop(next(iter(self._seg_cache)), None)
                self._seg_cache[path] = toks
        return toks

    # resolved-filter cache: serving batches repeat a handful of filter
    # signatures (a session glob, a collection); each miss costs an SQL scan
    # returning O(matches) ids. Generation = sqlite total_changes, so ANY
    # write to the metadata db invalidates (cheap, no false negatives).
    # Returning the SAME set object per signature also lets the engine dedup
    # identical per-query filters into one device mask row by id().
    _FILTER_CACHE_MAX = 512

    def _filter_doc_ids(
        self, tags: list[str] | None, path_glob: str | None,
        collection: str | None, filters: dict | None = None,
    ) -> set[int] | None:
        from .filters import resolve_filter_ids

        try:
            sig = (
                tuple(tags) if tags else None, path_glob, collection,
                tuple(sorted(
                    (k, tuple(v) if isinstance(v, list) else v)
                    for k, v in filters.items())) if filters else None,
            )
            hash(sig)
        except TypeError:  # exotic unhashable filter value: skip the cache
            return resolve_filter_ids(self.app, tags, path_glob, collection,
                                      filters)
        gen = self.app.db.conn.total_changes
        cache = self._filter_cache
        with self._seg_lock:
            hit = cache.get(sig)
            if hit is not None and hit[0] == gen:
                return hit[1]
        ids = resolve_filter_ids(self.app, tags, path_glob, collection,
                                 filters)
        with self._seg_lock:
            if len(cache) >= self._FILTER_CACHE_MAX:
                cache.pop(next(iter(cache)), None)
            cache[sig] = (gen, ids)
        return ids

    def search(
        self,
        query: str,
        limit: int = 10,
        search_type: str = "hybrid",   # auto | hybrid | semantic | vector | keyword | fts
        tags: list[str] | None = None,
        path_glob: str | None = None,
        collection: str | None = None,
        with_snippets: bool = True,
        fuzzy_retry: bool = True,
        filters: dict | None = None,
    ) -> SearchResponse:
        t0 = time.monotonic()
        md = self.app.metadata
        # inline qualifiers: `tag:x path:*.py collection:c type:keyword query…`
        from ..search.query import parse_qualifiers

        pq = parse_qualifiers(query)
        if pq.text != query or pq.tags or pq.path_glob or pq.collection:
            query = pq.text
            tags = list(tags or []) + pq.tags or None
            path_glob = path_glob or pq.path_glob
            collection = collection or pq.collection
            if pq.search_type:
                search_type = pq.search_type
        intent: str | None = None
        if search_type == "auto":
            # intent routing (reference: buildSearchRoutingPlan)
            from ..search.query import build_routing_plan

            plan = build_routing_plan(query)
            search_type = plan.mode
            query = plan.corrected_query
            intent = plan.intent
        filter_ids = self._filter_doc_ids(tags, path_glob, collection,
                                          filters)
        hits: list[SearchHit] = []

        if search_type == "fts":
            for r in md.search_fts(query, limit=limit * 2):
                if filter_ids is not None and r.document_id not in filter_ids:
                    continue
                try:
                    doc = md.get_document(r.document_id)
                except Exception:
                    continue
                hits.append(SearchHit(
                    document_id=r.document_id, score=r.score, path=doc.file_path,
                    name=doc.file_name, title=r.title, snippet=r.snippet,
                    text_score=r.score, hash=doc.sha256_hash,
                ))
                if len(hits) >= limit:
                    break
        else:
            mode = {"semantic": "vector", "vector": "vector",
                    "keyword": "keyword"}.get(search_type, "hybrid")
            results = self.app.search_engine.search(
                query, k=limit, mode=mode, filter_doc_ids=filter_ids,
                intent=intent,
            )
            # path-tree evidence leg (reference: search_engine.cpp:5101,
            # pathTreeWeight=0.08): query tokens matching path SEGMENTS boost
            # the fused score — distinct from the filename boost already
            # folded into the lexical title column
            from ..embed.simeon import tokenize as _tok

            q_toks = set(_tok(query))
            pt_w = self.app.search_engine.config.path_tree_weight
            for r in results:
                try:
                    doc = md.get_document(r.doc_id)
                except Exception:
                    continue
                snippet = ""
                if with_snippets:
                    snippet = self._snippet(r.doc_id, query)
                score = r.score
                if q_toks and pt_w > 0:
                    segs = [s for s in doc.file_path.lower().split("/") if s]
                    seg_toks = {t for s in segs[:-1] for t in _tok(s)}
                    overlap = len(q_toks & seg_toks)
                    if overlap:
                        score += pt_w * min(1.0, overlap / len(q_toks))
                hits.append(SearchHit(
                    document_id=r.doc_id, score=score, path=doc.file_path,
                    name=doc.file_name, title=r.title or doc.file_name,
                    snippet=snippet, text_score=r.text_score,
                    vector_score=r.vector_score, kg_score=r.kg_score,
                    hash=doc.sha256_hash,
                ))
            hits.sort(key=lambda h: -h.score)
            eng_cfg = self.app.search_engine.config
            lexical_hits = sum(1 for h in hits if h.text_score > 0)
            if (eng_cfg.enable_prf_expansion and fuzzy_retry and hits
                    and lexical_hits < eng_cfg.prf_min_lexical_hits
                    and search_type == "hybrid"):
                # PMI-ranked pseudo-relevance feedback: expand with terms the
                # top hits share but the corpus doesn't (opt-in, reference
                # enableLexicalExpansion)
                from ..search.query import prf_expansion

                lex = self.app.search_engine.lexical_index
                texts = []
                for h in hits[:3]:
                    t = self.app.metadata.get_content(h.document_id) or ""
                    if t:
                        texts.append(t[:4000])
                exp = prf_expansion(query, texts, global_df=lex.df_view(),
                                    n_docs=max(lex.doc_count, 1))
                if exp:
                    return self.search(
                        query + " " + " ".join(exp), limit, search_type,
                        tags, path_glob, collection, with_snippets,
                        fuzzy_retry=False, filters=filters,
                    )
            if not hits and fuzzy_retry:
                # zero hits: symspell-correct against the lexical vocab and
                # retry once (reference: symspell fuzzy fallback)
                from ..search.query import FuzzyCorrector

                vocab = self.app.search_engine.lexical_index._vocab
                if vocab:
                    corrected = FuzzyCorrector(vocab).correct_query(query)
                    if corrected != query:
                        return self.search(
                            corrected, limit, search_type, tags, path_glob,
                            collection, with_snippets, fuzzy_retry=False,
                            filters=filters,
                        )
            for h in hits[:3]:
                md.touch_hotzone(h.document_id, 0.2)
                self.app.search_engine.touch_hot(h.document_id, 0.2)

        min_score = (filters or {}).get("min_score")
        if min_score is not None:
            hits = [h for h in hits if h.score >= float(min_score)]
        return SearchResponse(
            hits=hits[:limit],
            total=len(hits),
            query=query,
            type=search_type,
            duration_ms=(time.monotonic() - t0) * 1e3,
        )

    def search_many(
        self,
        queries: list[str],
        limit: int = 10,
        search_type: str = "hybrid",
        with_snippets: bool = True,
    ) -> list[SearchResponse]:
        """Plain-path batch: N queries -> ONE device program -> per-query
        hydration. Thin wrapper over search_many_requests."""
        return self.search_many_requests(
            [{"query": q, "limit": limit, "search_type": search_type}
             for q in queries],
            with_snippets=with_snippets,
        )

    def search_many_requests(
        self, reqs: list[dict], with_snippets: bool = True,
    ) -> list[SearchResponse]:
        """Full-request batch: each request carries its own query, limit,
        search_type, tags/path_glob/collection/filters. Filtered requests
        ride the SAME fused device program as plain ones — per-request
        candidate sets become rows of the (B, Nd) doc mask (the pushdown
        rows topology Narrow uses). Same-mode requests group into one device
        call; fts/auto requests fall back to search(). Batched requests skip
        the zero-hit PRF/fuzzy retry tiers (single-path behavior otherwise)."""
        t0 = time.monotonic()
        from ..search.query import parse_qualifiers

        n = len(reqs)
        out: list[SearchResponse | None] = [None] * n
        # normalize each request: qualifiers fold into filters/type
        norm: list[dict] = []
        for i, r in enumerate(reqs):
            query = r.get("query", "")
            tags = r.get("tags")
            path_glob = r.get("path_glob")
            collection = r.get("collection")
            stype = r.get("search_type", "hybrid")
            pq = parse_qualifiers(query)
            if pq.text != query or pq.tags or pq.path_glob or pq.collection:
                query = pq.text
                tags = (list(tags or []) + pq.tags) or None
                path_glob = path_glob or pq.path_glob
                collection = collection or pq.collection
                if pq.search_type:
                    stype = pq.search_type
            norm.append({
                "i": i, "query": query, "tags": tags, "path_glob": path_glob,
                "collection": collection, "filters": r.get("filters"),
                "limit": int(r.get("limit", 10) or 10), "type": stype,
            })
        # fallback lane: modes the fused batch can't express
        mode_of = {"hybrid": "hybrid", "semantic": "vector",
                   "vector": "vector", "keyword": "keyword"}
        groups: dict[str, list[dict]] = {}
        for m in norm:
            mode = mode_of.get(m["type"])
            if mode is None:
                r = reqs[m["i"]]
                out[m["i"]] = self.search(
                    r.get("query", ""), limit=m["limit"],
                    search_type=m["type"] if m["type"] != "auto" else "auto",
                    tags=r.get("tags"), path_glob=r.get("path_glob"),
                    collection=r.get("collection"), filters=r.get("filters"),
                    with_snippets=with_snippets,
                )
            else:
                m["mode"] = mode
                groups.setdefault(mode, []).append(m)
        for mode, ms in groups.items():
            k = max(m["limit"] for m in ms)
            filters = [
                self._filter_doc_ids(m["tags"], m["path_glob"],
                                     m["collection"], m["filters"])
                for m in ms
            ]
            per_q = filters if any(f is not None for f in filters) else None
            batches = self.app.search_engine.search_batch(
                [m["query"] for m in ms], k=k, mode=mode,
                per_query_filters=per_q,
            )
            for m, results in zip(ms, batches):
                resp = self._hydrate(
                    m["query"], results, m["limit"], m["type"],
                    with_snippets, t0,
                    min_score=(m["filters"] or {}).get("min_score"),
                )
                out[m["i"]] = resp
        return out  # type: ignore[return-value]

    def _hydrate(self, query: str, results, limit: int, search_type: str,
                 with_snippets: bool, t0: float,
                 min_score=None) -> SearchResponse:
        md = self.app.metadata
        from ..embed.simeon import tokenize as _tok

        pt_w = self.app.search_engine.config.path_tree_weight
        q_toks = set(_tok(query))
        # clone=False: hit building only READS doc fields (path/name/hash)
        docs = md.get_documents([r.doc_id for r in results], clone=False)
        # score + order first, materialize SearchHit objects only for the
        # returned window (the candidate list is ~6x limit wide; building a
        # dataclass per candidate was measurable serving glue)
        scored: list[tuple] = []
        for r in results:
            doc = docs.get(r.doc_id)
            if doc is None:
                continue
            score = r.score
            if q_toks and pt_w > 0:
                overlap = len(q_toks & self._seg_tokens(doc.file_path))
                if overlap:
                    score += pt_w * min(1.0, overlap / len(q_toks))
            scored.append((score, r, doc))
        scored.sort(key=lambda t: -t[0])
        if min_score is not None:
            ms = float(min_score)
            scored = [t for t in scored if t[0] >= ms]
        total = len(scored)
        hits = [
            SearchHit(
                document_id=r.doc_id, score=score, path=doc.file_path,
                name=doc.file_name, title=r.title or doc.file_name,
                snippet="", text_score=r.text_score,
                vector_score=r.vector_score, kg_score=r.kg_score,
                hash=doc.sha256_hash,
            )
            for score, r, doc in scored[:limit]
        ]
        if with_snippets:
            # snippets only for the RETURNED window — the candidate list is
            # k_dev (~6x limit) wide and snippet extraction is the single
            # most expensive hydration step
            for h in hits:
                h.snippet = self._snippet(h.document_id, query)
        return SearchResponse(
            hits=hits, total=total, query=query,
            type=search_type,
            duration_ms=(time.monotonic() - t0) * 1e3,
        )

    def _snippet(self, doc_id: int, query: str, width: int = 160) -> str:
        from ..embed.simeon import tokenize

        # hot queries repeat (doc, query) pairs every batch; content writes
        # bump sqlite total_changes, which keys the entry out
        gen = self.app.db.conn.total_changes
        key = (doc_id, query)
        with self._seg_lock:
            hit = self._snippet_cache.get(key)
            if hit is not None and hit[0] == gen:
                return hit[1]
        snip = self._snippet_uncached(doc_id, query, width)
        with self._seg_lock:
            if len(self._snippet_cache) >= self.SEG_CACHE_MAX:
                self._snippet_cache.pop(next(iter(self._snippet_cache)), None)
            self._snippet_cache[key] = (gen, snip)
        return snip

    def _snippet_uncached(self, doc_id: int, query: str,
                          width: int = 160) -> str:
        from ..embed.simeon import tokenize

        text = self.app.metadata.get_content(doc_id)
        if not text:
            return ""
        lowered = text.lower()
        for tok in tokenize(query):
            pos = lowered.find(tok)
            if pos >= 0:
                start = max(0, pos - width // 3)
                end = min(len(text), pos + width)
                prefix = "..." if start > 0 else ""
                suffix = "..." if end < len(text) else ""
                return prefix + text[start:end].replace("\n", " ") + suffix
        return text[:width].replace("\n", " ")

    def semantic_dedupe(
        self, threshold: float = 0.8, limit_docs: int = 2000
    ) -> list[dict]:
        """Near-duplicate document pairs via MinHash/LSH
        (MCP semantic_dedupe tool parity)."""
        from ..utils.minhash import find_near_duplicates

        rows = self.app.db.execute(
            "SELECT document_id, content_text FROM document_content LIMIT ?",
            (limit_docs,),
        ).fetchall()
        texts = {r[0]: r[1] for r in rows if r[1]}
        pairs = find_near_duplicates(texts, threshold=threshold)
        out = []
        for a, b, j in pairs:
            try:
                out.append({
                    "a": self.app.metadata.get_document(a).file_path,
                    "b": self.app.metadata.get_document(b).file_path,
                    "similarity": round(j, 3),
                })
            except Exception:
                pass
        return out

    def suggest_context(self, query: str, limit: int = 5, max_chars: int = 4000) -> str:
        """Concatenated snippets for LLM context (MCP suggest_context tool)."""
        resp = self.search(query, limit=limit)
        parts = []
        budget = max_chars
        for h in resp.hits:
            text = self.app.metadata.get_content(h.document_id) or h.snippet
            piece = f"=== {h.path} (score {h.score:.3f}) ===\n{text[: budget // 2]}\n"
            parts.append(piece)
            budget -= len(piece)
            if budget <= 0:
                break
        return "".join(parts)
