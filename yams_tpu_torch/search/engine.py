"""SearchEngine on torch: the hybrid tiers of yams_tpu's engine.

Port of yams_tpu/search/engine.py for the paths a search takes:
`add_document(s)` and `remove_document` (host tokenization, embeddings by
the engine's provider, index updates; sentence, paragraph, fixed and
semantic chunking), `search` / `search_batch` / `search_expanded` on the
dense tier (search_batch's default branch, engine.py:592-1020: the bf16 or
int8 corpus, the materialized or, on a flat corpus above
`streaming_threshold` rows, the streaming vector leg, every chunk
aggregation, intent-adaptive leg weights), the PQ capacity tier (`ensure_pq`
and search_batch's `use_pq` branch, engine.py:498-535, 849-897), the
hotzone (`touch_hot`, `clear_hot`, `record_feedback`: boosts h / (1 + h)
on the device, rebuilt only when they or the slot layout change), `stats`,
the knowledge-graph leg over a `kg_store` (alias matches and the entity
side index, `add_entity_vectors`, searched once a batch on the device), the
graph rerank, the `cross_reranker` hook, semantic rescue, the search tuner's
arms and rewards, topology routing (`rebuild_topology` over the port's
TopologyEngine on the engine's device, `route_calibration`, shadow ->
narrow auto-promotion, and search_batch under the off, shadow, narrow and
augment policies: the per-query narrow masks, the narrow gather tier
through `routed_gather_topk` at 0 < B <= narrow_gather_max_batch, the
shadow agreement and route-risk calibration, :364-494, 755-824, 895-925,
1105-1129), the late-interaction (ColBERT) tier and the fragment-geometry
arm (`enable_late_interaction`, `enable_fragment_geometry`, their index
hooks in add and remove, and their MaxSim rerank stages over the fused
candidates, `late_interaction_ms` and `fragment_geometry_ms` in the trace,
:256-290, 1039-1099), and the result glue (:1131-1216). The host state
lives in the port's VectorIndex / LexicalIndex / TokenIndex, copies of the
reference's host code with torch device views, so both engines hold
identical state for identical adds. It runs on the card unless the caller
asks for the CPU.

`provider` is any provider of embed/provider.py (simeon by default, on the
engine's device). `self.encoder` is the provider's encoder where it has
one (neural, hf), else the provider itself: the port's SimeonProvider holds
what the reference's SimeonEncoder does (config, encode, space_id).

The PQ tier's vector leg is `VectorIndex.search_pq` with the doc mask
always pushed into the scan (all ones over the used slots when unfiltered),
as in the reference, so it runs the plain pq_adc_topk and never the K4
kernel, whose route is the unfiltered scan only.

The narrow gather tier's trace also carries `topology_route_ms` (the
reference records it for the masked routes only).

Not ported, and refused loudly (NotImplementedError) rather than skipped:
sharded serving (ROADMAP queue 1 item 9) and vector engines other than
dense, pq and pq4.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time

import numpy as np
import torch

from ..core.config import EmbeddingConfig, LexicalIndexConfig, VectorIndexConfig
from ..device import resolve_device
from ..embed.chunker import chunk_document
from ..embed.provider import SimeonProvider
from ..embed.simeon import tokenize
from ..index.lexical_index import LexicalIndex
from ..index.topology import TopologyEngine
from ..index.vector_index import VectorIndex
from ..ops.maxsim import maxsim_scores
from ..ops.scan import routed_gather_topk
from .config import SearchEngineConfig
from .fusion import (NEG, W_TEXT, W_VEC, hybrid_fuse_precomputed, hybrid_query,
                     pack_weights)
from .query import intent_weight_multipliers
from .tuner import corpus_profile


@dataclasses.dataclass(slots=True)
class SearchResult:
    doc_id: int
    score: float
    text_score: float = 0.0
    vector_score: float = 0.0
    kg_score: float = 0.0
    title: str = ""
    snippet: str = ""


def _round_pow2(x: int, floor: int = 1024) -> int:
    n = floor
    while n < x:
        n *= 2
    return n


def _aggregate_pq_candidates(
    vals: np.ndarray, slots: np.ndarray, num_slots: int, chunk_agg: str,
) -> tuple[np.ndarray, np.ndarray]:
    """Chunk->doc aggregation of the PQ tier's host-side candidate list
    (max | sum | topk_avg | weighted_topk_avg over the candidate window).
    Returns (values, slots) sorted by aggregated score descending. A copy of
    the reference's function: its module imports jax."""
    ok = (slots >= 0) & (slots < num_slots) & (vals > -1e29)
    v, s = vals[ok].astype(np.float32), slots[ok]
    if not len(s):
        return v, s
    uniq, inv = np.unique(s, return_inverse=True)
    m1 = np.full(len(uniq), -1e30, np.float32)
    np.maximum.at(m1, inv, v)
    if chunk_agg == "sum":
        agg = np.zeros(len(uniq), np.float32)
        np.add.at(agg, inv, np.maximum(v, 0.0))
    elif chunk_agg in ("topk_avg", "weighted_topk_avg"):
        v2 = np.where(v >= m1[inv], -np.float32(1e30), v)
        m2 = np.full(len(uniq), -1e30, np.float32)
        np.maximum.at(m2, inv, v2)
        m2 = np.where(m2 <= -1e29, m1, m2)  # single-chunk docs
        agg = ((m1 + m2) * 0.5 if chunk_agg == "topk_avg"
               else (m1 + 0.5 * m2) / 1.5)
    else:  # max (default)
        agg = m1
    order = np.argsort(-agg, kind="stable")
    return agg[order], uniq[order].astype(np.int32)


def _blend(vals, slots, bm_at, vec_at, weight: float, scores: np.ndarray):
    """Add weight * clip(scores, -1, 1) to the live candidates' fused values
    and re-sort every (B, C) array by the blend (stable)."""
    live = vals > -1e29
    blended = np.where(live, vals + weight * np.clip(scores, -1, 1), vals)
    order = np.argsort(-blended, axis=1, kind="stable")
    return (np.take_along_axis(blended, order, axis=1),
            *(np.take_along_axis(a, order, axis=1) for a in (slots, bm_at, vec_at)))


class SearchEngine:
    def __init__(
        self,
        config: SearchEngineConfig | None = None,
        embedding: EmbeddingConfig | None = None,
        vector: VectorIndexConfig | None = None,
        lexical: LexicalIndexConfig | None = None,
        kg_store=None,
        provider=None,
        *,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or SearchEngineConfig()
        self.provider = provider or SimeonProvider(embedding, device=self.device)
        # the provider's encoder (neural, hf), else the provider itself
        self.encoder = getattr(self.provider, "encoder", None) or self.provider
        vcfg = vector or VectorIndexConfig(dim=self.provider.dim)
        if str(vcfg.engine) not in ("dense", "pq", "pq4"):
            raise NotImplementedError(
                f"vector engine {vcfg.engine!r}: only the dense, pq and pq4 "
                "engines are ported")
        self.vector_config = vcfg
        self.vector_index = VectorIndex(
            dim=self.provider.dim,
            capacity=vcfg.capacity,
            block_rows=vcfg.block_rows,
            space_id=self.provider.space_id,
            device_dtype="int8" if vcfg.dtype == "int8" else "bfloat16",
            device=self.device,
        )
        self.lexical_index = LexicalIndex(lexical)
        self.kg = kg_store
        # KG node labels embedded into a small side index; slot == node id
        self.entity_index = VectorIndex(
            dim=self.provider.dim, capacity=1024, block_rows=256,
            space_id=self.provider.space_id + "/entities", device=self.device)
        self.topology = None        # TopologyEngine, built via rebuild_topology()
        self.topology_tuner = None  # TopologyTuner, opt-in (engine-selection MAB)
        self.tuner = None           # SearchTuner, opt-in (the caller sets it)
        self.token_index = None     # TokenIndex, opt-in (ColBERT rerank tier)
        self.fragment_index = None  # FragmentIndex, opt-in (fragment geometry)
        self.cross_reranker = None  # optional callable(query, [SearchResult]) -> list
        self.last_trace: dict | None = None
        self._proj_host: np.ndarray | None = None
        # doc identity: external doc_id <-> dense slot
        self._slot_by_doc: dict[int, int] = {}
        self._doc_by_slot: list[int] = []
        self._titles: dict[int, str] = {}
        self._hot: dict[int, float] = {}
        self._hot_gen = 0
        self._hot_dev: tuple | None = None  # ((gen, Nd, n_slots), tensor)
        self._lock = threading.RLock()
        self._stats = {
            "searches": 0, "total_ms": 0.0, "documents": 0,
            "topology_routes": 0, "topology_shadow_agree": 0.0,
            "topology_abstained": 0, "topology_budget_clamped": 0,
            "topology_promotions": 0,
        }
        # shadow-route miss-risk calibration for the CURRENT topology build
        # (an empty fingerprint or zero observations leaves risk
        # UNAVAILABLE, not zero)
        self._route_calib = {
            "fingerprint": "", "queries": 0, "protected": 0, "missed": 0,
        }

    # -- identity -----------------------------------------------------------------
    def _slot_for(self, doc_id: int) -> int:
        with self._lock:
            s = self._slot_by_doc.get(doc_id)
            if s is None:
                s = len(self._doc_by_slot)
                self._slot_by_doc[doc_id] = s
                self._doc_by_slot.append(doc_id)
            return s

    @property
    def num_slots_padded(self) -> int:
        return _round_pow2(max(len(self._doc_by_slot), 1))

    # -- indexing -----------------------------------------------------------------
    def add_document(self, doc_id: int, content: str, title: str = "",
                     chunk_strategy: str = "sentence") -> int:
        """Index one document (lexical + chunked vectors). Returns #chunks."""
        return self.add_documents([(doc_id, content, title)], chunk_strategy)[0]

    def add_documents(self, docs: list[tuple[int, str, str]],
                      chunk_strategy: str = "sentence") -> list[int]:
        """Batched indexing: [(doc_id, content, title)] -> #chunks per doc;
        every chunk text is embedded in one provider call."""
        all_texts: list[str] = []
        vec_slots: list[int] = []
        counts: list[int] = []
        embedder = self.provider.encode if chunk_strategy == "semantic" else None
        for doc_id, content, title in docs:
            slot = self._slot_for(doc_id)
            with self._lock:
                self._titles[doc_id] = title
            self.vector_index.remove_doc(slot)
            self.lexical_index.add_document(slot, content, title)
            texts = [c.text for c in chunk_document(content, chunk_strategy,
                                                    embedder=embedder)]
            if title:
                texts = [title] + texts
            counts.append(len(texts))
            all_texts.extend(texts)
            vec_slots.extend([slot] * len(texts))
        if all_texts:
            self.vector_index.add(self.provider.encode(all_texts), vec_slots)
        if self.token_index is not None:
            for doc_id, content, title in docs:
                self.token_index.set_doc(self._slot_by_doc[doc_id], self.provider.encode_tokens(
                    (title + " " + content) if title else content,
                    max_tokens=self.config.late_interaction_max_tokens))
        if self.fragment_index is not None:
            for doc_id, content, title in docs:
                self.fragment_index.set_doc_text(
                    self._slot_by_doc[doc_id], (title + " " + content) if title else content,
                    self.provider, n_sentences=self.config.fragment_top_sentences)
        self._stats["documents"] = len(self._slot_by_doc)
        return counts

    def enable_late_interaction(self) -> None:
        """Turn on the ColBERT-tier MaxSim rerank. Existing docs must be
        re-added to populate token embeddings."""
        from ..index.token_index import TokenIndex

        self.token_index = TokenIndex(
            dim=self.provider.dim,
            max_tokens=self.config.late_interaction_max_tokens,
            device=self.device,
        )

    def enable_fragment_geometry(self) -> None:
        """Turn on the fragment-geometry rerank arm (opt-in, as in the
        reference). Existing docs must be re-added to populate sentence
        embeddings."""
        from ..index.fragment_index import FragmentIndex

        self.fragment_index = FragmentIndex(
            dim=self.provider.dim,
            max_tokens=self.config.fragment_top_sentences,
            device=self.device,
        )

    def remove_document(self, doc_id: int) -> bool:
        """Drop a document from every index; its slot stays reserved."""
        with self._lock:
            slot = self._slot_by_doc.get(doc_id)
        if slot is None:
            return False
        self.vector_index.remove_doc(slot)
        self.lexical_index.remove_document(slot)
        if self.token_index is not None:
            self.token_index.remove_doc(slot)
        if self.fragment_index is not None:
            self.fragment_index.remove_doc(slot)
        self._titles.pop(doc_id, None)
        return True

    # -- hotzone (feedback) -----------------------------------------------------
    def touch_hot(self, doc_id: int, boost: float = 1.0) -> None:
        with self._lock:
            self._hot[doc_id] = self._hot.get(doc_id, 0.0) + boost
            self._hot_gen += 1

    def clear_hot(self) -> None:
        """Reset hotzone state (evaluation harnesses isolate runs with this)."""
        with self._lock:
            self._hot.clear()
            self._hot_gen += 1

    def _hot_device(self, Nd: int) -> torch.Tensor:
        """The (Nd,) boost vector h / (1 + h) on the device, rebuilt only
        when the hot state or the slot layout changed."""
        with self._lock:
            key = (self._hot_gen, Nd, len(self._doc_by_slot))
            cached = self._hot_dev
            if cached is not None and cached[0] == key:
                return cached[1]
            hot = np.zeros(Nd, np.float32)
            for d, h in self._hot.items():
                s = self._slot_by_doc.get(d)
                if s is not None:
                    hot[s] = h / (1.0 + h)
            dev = torch.from_numpy(hot).to(self.device)
            self._hot_dev = (key, dev)
            return dev

    def record_feedback(self, doc_id: int, relevant: bool = True) -> None:
        """Click/relevance feedback: rewards the bandit + hotzone."""
        if relevant:
            self.touch_hot(doc_id, 1.0)
        if self.tuner is not None:
            self.tuner.record_reward(
                1.0 if relevant else 0.0,
                profile=corpus_profile(len(self._slot_by_doc)),
            )

    # -- topology (reference: TopologyManager + topology_routing_session) ---------
    def rebuild_topology(self, iters: int = 8, engine: str | None = None) -> None:
        vi = self.vector_index
        if vi.active_rows == 0:
            return
        eng = TopologyEngine(
            iters=iters,
            representatives=self.config.topology_representatives,
            device=self.device,
        )
        if engine is not None:
            arts = eng.build(
                vi._vecs, vi._valid, epoch=self._stats["searches"],
                engine=engine,
            )
        else:
            arts = eng.build_auto(
                vi._vecs, vi._valid, epoch=self._stats["searches"],
                tuner=self.topology_tuner,
            )
        self.topology = eng
        # rebuild-quality signal (reference: clusterCentroidPersistence reward)
        self._stats["topology_persistence"] = arts.centroid_persistence
        # a new build voids any accumulated route-risk evidence (reference:
        # constructionFingerprint — calibration is per-construction)
        self._route_calib = {
            "fingerprint": f"{arts.epoch}/{len(arts.centroids)}",
            "queries": 0, "protected": 0, "missed": 0,
        }

    def route_calibration(self) -> dict:
        """Route-risk certificate for the current topology build.

        `available` stays False until >= topology_calibration_min_queries
        shadow observations exist for THIS construction (reference: a zero
        observation count leaves route risk unavailable rather than zero)."""
        c = dict(self._route_calib)
        cfg = self.config
        c["available"] = (
            bool(c["fingerprint"])
            and c["queries"] >= cfg.topology_calibration_min_queries
            and c["protected"] > 0
        )
        c["misses_per_thousand"] = (
            1000.0 * c["missed"] / c["protected"] if c["protected"] else None
        )
        return c

    def _maybe_promote_narrow(self) -> bool:
        """Shadow -> Narrow auto-promotion, gated on the calibration
        certificate (reference: maxMissesPerThousand)."""
        c = self.route_calibration()
        if not c["available"]:
            return False
        if c["misses_per_thousand"] > self.config.topology_calibration_max_mpt:
            return False
        self.config.topology_policy = "narrow"
        self._stats["topology_promotions"] += 1
        return True

    def _lexical_seed_rows(self, query: str) -> np.ndarray | None:
        """Top lexical docs' chunk rows — the sparse routing leg's voters
        (reference: topologyMaxSeedDocuments highest-ranked lexical docs).

        Host-side and cheap: per query term, idf-weighted tf votes over the
        in-memory postings (terms with df > 4096 skipped — too common to
        discriminate a cluster), top seed docs by vote, then their chunk
        rows via the vector index slot map."""
        n_seeds = self.config.topology_max_seed_docs
        if n_seeds <= 0:
            return None
        lex = self.lexical_index
        tids, weights = lex.query_term_ids(query)
        n_docs = max(lex.doc_count, 1)
        votes: dict[int, float] = {}
        for tid, w in zip(tids, weights):
            if w <= 0:
                continue
            plist = lex._postings.get(int(tid))
            if not plist or len(plist) > 4096:
                continue
            idf = float(np.log1p(n_docs / len(plist)))
            for slot, tf in plist.items():
                votes[slot] = votes.get(slot, 0.0) + w * idf * float(tf)
        if not votes:
            return None
        top = sorted(votes, key=votes.get, reverse=True)[:n_seeds]
        slots = self.vector_index._slots
        return np.nonzero(np.isin(slots, np.asarray(top)))[0]

    def _route_query(self, query_vec: np.ndarray, query: str | None = None):
        """One query's RouteSelection under the configured routing knobs."""
        cfg = self.config
        seeds = (self._lexical_seed_rows(query)
                 if query is not None else None)
        return self.topology.select_routes(
            query_vec, seeds,
            min_clusters=cfg.topology_min_clusters,
            max_clusters=cfg.topology_top_clusters,
            adaptive_score_gap=cfg.topology_adaptive_score_gap,
            alpha=cfg.topology_sparse_dense_alpha,
            min_boundary_margin=cfg.topology_narrow_min_boundary_margin,
            budget_rows=cfg.topology_route_budget_rows,
        )

    def _routed_slot_mask(self, query_vec: np.ndarray, num_slots: int,
                          query: str | None = None) -> np.ndarray:
        """Topology route -> slot-level scan mask (cluster members only).

        An abstained route (boundary margin below the narrow gate) returns
        the FULL mask: narrowing without a trustworthy certificate is how
        recall silently dies (reference: selection.abstained)."""
        sel = self._route_query(query_vec, query)
        if sel.abstained:
            self._stats["topology_abstained"] += 1
            return np.ones(num_slots, np.float32)
        if sel.budget_clamped:
            self._stats["topology_budget_clamped"] += 1
        row_mask = self.topology.routed_row_mask(
            query_vec, policy="narrow", selection=sel,
        )
        slots = self.vector_index._slots
        mask = np.zeros(num_slots, np.float32)
        routed_slots = np.unique(slots[: len(row_mask)][row_mask > 0])
        routed_slots = routed_slots[(routed_slots >= 0) & (routed_slots < num_slots)]
        mask[routed_slots] = 1.0
        if not routed_slots.size:
            # empty-route fallback identity: an empty route is exactly the
            # global scan (reference contract:
            # Topology/SelectiveRouting.lean selectiveRoute_emptyFallback_identity)
            mask[:] = 1.0
        return mask

    # -- PQ engine lifecycle ----------------------------------------------------
    def ensure_pq(self) -> bool:
        """Build/refresh PQ codebooks when a pq engine is configured
        (VectorIndexConfig.engine = 'pq' | 'pq4'): first once active rows
        reach pq_min_rows, again when the corpus has doubled since the last
        build. Returns True if a (re)build ran."""
        vcfg = self.vector_config
        if not str(vcfg.engine).startswith("pq"):
            return False
        idx = self.vector_index
        n = idx.active_rows
        if n < max(vcfg.pq_min_rows, 2):
            return False
        built = getattr(idx, "_pq_built_rows", 0)
        if idx.has_pq and n < 2 * max(built, 1):
            return False
        pack4 = vcfg.engine == "pq4"
        group = vcfg.pq_group
        if group == 0:  # auto: grouped windows only where the sort dominates
            group = 64 if n >= 1_000_000 and idx.block_rows % 64 == 0 else 1
        idx.build_pq(
            m=vcfg.pq_m,
            ksub=min(vcfg.pq_ksub, 16) if pack4 else vcfg.pq_ksub,
            train_limit=vcfg.pq_train_limit,
            rerank_factor=vcfg.pq_rerank_factor,
            pack4=pack4,
            group=group,
        )
        idx._pq_built_rows = n
        idx._pq_sel_width = int(self.config.approx_sel_width)
        return True

    # -- search ---------------------------------------------------------------------
    def search(self, query: str, k: int = 10, mode: str = "hybrid",
               filter_doc_ids: set[int] | None = None,
               intent: str | None = None) -> list[SearchResult]:
        return self.search_batch([query], k, mode, filter_doc_ids, intent)[0]

    def search_expanded(self, query: str, expansions: list[str], k: int = 10,
                        mode: str = "hybrid", filter_doc_ids: set[int] | None = None,
                        intent: str | None = None) -> list[SearchResult]:
        """Multi-vector query: the query and up to 7 expansion variants run
        as rows of one batch, then merge per doc: the max over variants,
        expansions discounted by expansion_score_penalty."""
        variants = [query] + [e for e in expansions if e][:7]
        per_variant = self.search_batch(variants, k=k, mode=mode,
                                        filter_doc_ids=filter_doc_ids, intent=intent)
        pen = self.config.expansion_score_penalty
        best: dict[int, SearchResult] = {}
        for vi, results in enumerate(per_variant):
            scale = 1.0 if vi == 0 else pen
            for r in results:
                scaled = dataclasses.replace(r, score=r.score * scale)
                cur = best.get(r.doc_id)
                if cur is None or scaled.score > cur.score:
                    best[r.doc_id] = scaled
        return sorted(best.values(), key=lambda r: -r.score)[:k]

    def _candidates(self, vals, slots, B_real, B, rrf_c, Nd, chunk_agg):
        """Per-query chunk -> doc aggregation of a host candidate list ->
        ((B, rrf_c) values, (B, rrf_c) slots, sink Nd where empty)."""
        vv = np.full((B, rrf_c), NEG, np.float32)
        vs = np.full((B, rrf_c), Nd, np.int32)
        for i in range(B_real):
            vals_i, slots_i = _aggregate_pq_candidates(vals[i], slots[i], Nd, chunk_agg)
            n_i = min(len(vals_i), rrf_c)
            vv[i, :n_i] = vals_i[:n_i]
            vs[i, :n_i] = slots_i[:n_i]
        return vv, vs

    def _pq_candidates(self, qv, B_real, B, rrf_c, Nd, doc_mask, mask_idx, mode):
        """The PQ tier's vector leg: ADC scan with the doc mask pushed in,
        host rerank, chunk -> doc aggregation. `qv` is the batch's memo of
        host query vectors."""
        if mode == "keyword":
            return (np.full((B, rrf_c), NEG, np.float32),
                    np.full((B, rrf_c), Nd, np.int32))
        qv = qv()
        if mask_idx is not None:
            dmq = doc_mask[mask_idx[:B_real]]
        elif doc_mask.ndim == 1:
            dmq = doc_mask
        else:
            dmq = doc_mask[:B_real]
        vi = self.vector_index
        pvals, prows = vi.search_pq(qv, k=rrf_c, rerank="host", doc_mask=dmq)
        pslots = np.where(
            prows >= 0,
            vi.slots_of_rows(np.maximum(prows, 0).reshape(-1)).reshape(prows.shape),
            -1)
        return self._candidates(pvals, pslots, B_real, B, rrf_c, Nd,
                                self.config.chunk_agg)

    def _gather_candidates(self, qv, E, row_idx, row_ok, B_real, B, rrf_c, Nd,
                           chunk_agg):
        """The narrow gather tier's vector leg: routed_gather_topk over each
        query's routed rows, then chunk -> doc aggregation."""
        dev = self.device
        gv, grows = routed_gather_topk(
            torch.from_numpy(qv).to(dev), E, torch.from_numpy(row_idx).to(dev),
            torch.from_numpy(row_ok).to(dev), k=min(rrf_c, row_idx.shape[1]))
        gv, grows = gv.cpu().numpy(), grows.cpu().numpy()
        gslots = np.where(
            gv > -1e29,
            self.vector_index.slots_of_rows(
                np.maximum(grows, 0).reshape(-1)).reshape(gv.shape),
            -1)
        return self._candidates(gv, gslots, B_real, B, rrf_c, Nd, chunk_agg)

    def search_batch(
        self,
        queries: list[str],
        k: int = 10,
        mode: str = "hybrid",
        filter_doc_ids: set[int] | None = None,
        intent: str | None = None,
        per_query_filters: list[set[int] | None] | None = None,
    ) -> list[list[SearchResult]]:
        """Batched hybrid search on the dense or the PQ tier (the argument
        contract of yams_tpu/search/engine.py SearchEngine.search_batch)."""
        t0 = time.monotonic()
        trace: dict = {"query_count": len(queries), "mode": mode, "stages": {}}
        if not self._doc_by_slot:
            return [[] for _ in queries]
        cfg = self.config
        if self.tuner is not None and mode == "hybrid":
            _, tuner_arm = self.tuner.select(corpus_profile(len(self._slot_by_doc)))
            cfg = tuner_arm.apply(cfg)
            trace["tuner_arm"] = tuner_arm.name
        dev = self.device
        Nd = self.num_slots_padded
        B_real = len(queries)
        B = max(cfg.batch_pad, _round_pow2(B_real, floor=cfg.batch_pad))
        rrf_c = min(max(cfg.rrf_candidates, k), Nd)
        k_dev = min(max(k * 2, cfg.rrf_candidates), 2 * rrf_c)

        sketches, proj = self.provider.query_device_inputs(queries)
        sketches = np.pad(np.asarray(sketches), ((0, B - B_real), (0, 0)))
        qvecs_cache: np.ndarray | None = None

        def _query_vecs() -> np.ndarray:
            # host query vectors for the PQ and entity legs, once a batch:
            # sketch @ proj (a cached host copy), L2-normalized
            nonlocal qvecs_cache
            if qvecs_cache is None:
                ph = self._proj_host
                if ph is None or ph.shape[0] != sketches.shape[1]:
                    ph = self._proj_host = proj.float().cpu().numpy()
                v = sketches[:B_real].astype(np.float32) @ ph
                v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
                qvecs_cache = v
            return qvecs_cache
        tids = np.zeros((B, self.lexical_index.config.max_query_terms), np.int32)
        tmask = np.zeros_like(tids, dtype=np.float32)
        arm = getattr(cfg, "lexical_arm", "auto") or "auto"
        arms_used: list[str] = []
        for i, qtext in enumerate(queries):
            ids, m, used = self.lexical_index.query_arm_terms(qtext, arm=arm)
            tids[i], tmask[i] = ids, m
            arms_used.append(used)
        trace["lexical_arms"] = arms_used
        # weak-query fanout: every query has <=1 exact vocab term
        if (cfg.weak_query_rrf_candidates > cfg.rrf_candidates
                and all((tmask[i] >= 1.0).sum() <= 1 for i in range(B_real))):
            rrf_c = min(max(cfg.weak_query_rrf_candidates, k), Nd)
            trace["weak_query_fanout"] = True
        trace["stages"]["host_prep_ms"] = (time.monotonic() - t0) * 1e3

        w = pack_weights(cfg)
        if mode == "keyword":
            w[W_VEC] = 0.0
        elif mode == "vector":
            w[W_TEXT] = 0.0
        elif intent is not None and cfg.intent_adaptive:
            # intent-adaptive leg weighting rides the weight vector
            tm, vm = intent_weight_multipliers(intent)
            w[W_TEXT] *= tm
            w[W_VEC] *= vm
            trace["intent"] = intent

        # PQ capacity tier: the dense matrix never reaches the device; the
        # vector leg runs as ADC scan + host rerank outside the fused query
        use_pq = cfg.pq_tier_enabled and self.vector_index.has_pq
        if not use_pq:
            E, row_valid, row2slot, row_scale = self.vector_index.device_arrays()
        bm = self.lexical_index.device_arrays(Nd, dev)
        n_used = len(self._doc_by_slot)

        def _mask_of(ids: set[int] | None) -> np.ndarray:
            m = np.zeros(Nd, np.uint8)
            if ids is None:
                m[:n_used] = 1
            elif ids:
                sl = np.fromiter((self._slot_by_doc.get(d, -1) for d in ids),
                                 np.int64, count=len(ids))
                m[sl[sl >= 0]] = 1
            return m

        # one uint8 mask row per DISTINCT filter set + a per-query row index
        mask_idx: np.ndarray | None = None
        if per_query_filters is not None:
            if len(per_query_filters) != B_real:
                raise ValueError("per_query_filters needs one entry per query")
            row_of: dict[int, int] = {}
            rows: list[np.ndarray] = []
            idx = np.zeros(B, np.int32)
            for i, ids in enumerate(per_query_filters):
                key = -1 if ids is None else id(ids)
                r = row_of.get(key)
                if r is None:
                    eff = ids
                    if filter_doc_ids is not None:
                        eff = (filter_doc_ids if ids is None
                               else (ids & filter_doc_ids))
                    rows.append(_mask_of(eff))
                    r = len(rows) - 1
                    row_of[key] = r
                idx[i] = r
            rows.append(np.zeros(Nd, np.uint8))  # padded queries match nothing
            idx[B_real:] = len(rows) - 1
            U = _round_pow2(len(rows), floor=4)
            base_mask = np.zeros((U, Nd), np.uint8)
            base_mask[: len(rows)] = np.stack(rows)
            mask_idx = idx
        else:
            base_mask = _mask_of(filter_doc_ids)

        # topology routing: narrow -> per-query scan masks; shadow ->
        # counterfactual masks kept for agreement stats; augment/off -> full
        # scan
        policy = cfg.topology_policy if self.topology is not None else "off"
        shadow_masks: list[np.ndarray] | None = None
        doc_mask: np.ndarray = base_mask

        # narrow gather tier: at small batches, score only the routed rows
        # (routed_gather_topk) instead of mask-scanning all N. Falls through
        # to the masked narrow path when any query abstains, filters are
        # active, or a route has no live member.
        narrow_gather: tuple[np.ndarray, np.ndarray] | None = None
        if (policy == "narrow" and mode != "keyword" and not use_pq
                and 0 < B_real <= cfg.narrow_gather_max_batch
                and filter_doc_ids is None and per_query_filters is None):
            t_r = time.monotonic()
            qvecs = _query_vecs()
            sels = [self._route_query(qv, qt) for qv, qt in zip(qvecs, queries)]
            if not any(s.abstained for s in sels):
                valid_host = self.vector_index._valid
                slots_host = self.vector_index._slots
                rowlists = [self.topology.member_rows(s.clusters) for s in sels]
                # an empty route is the global scan: the masked path below
                # does that, so leave the gather tier
                live_lists = [rl[valid_host[rl] > 0] for rl in rowlists]
                rmax = max((len(r) for r in live_lists), default=0)
                if rmax and all(len(r) for r in live_lists):
                    R = min(_round_pow2(rmax, floor=64),
                            self.vector_index.capacity)
                    row_idx = np.zeros((B_real, R), np.int32)
                    row_ok = np.zeros((B_real, R), np.float32)
                    # narrow gates the whole pipeline: the lexical leg sees
                    # the routed slot masks too
                    masks = np.zeros((B, Nd), np.uint8)
                    for i, rl in enumerate(live_lists):
                        row_idx[i, : len(rl)] = rl
                        row_ok[i, : len(rl)] = 1.0
                        sl = slots_host[rl]
                        masks[i, sl[(sl >= 0) & (sl < Nd)]] = 1
                    narrow_gather = (row_idx, row_ok)
                    doc_mask = masks
                    self._stats["topology_routes"] += B_real
                    trace["narrow_gather_rows"] = int(R)
                    trace["stages"]["topology_route_ms"] = \
                        (time.monotonic() - t_r) * 1e3

        if (policy in ("narrow", "shadow") and mode != "keyword"
                and narrow_gather is None):
            t_r = time.monotonic()
            qvecs = _query_vecs()
            routed = [self._routed_slot_mask(qv, Nd, query=qt)
                      for qv, qt in zip(qvecs, queries)]
            self._stats["topology_routes"] += len(routed)
            if policy == "narrow":
                # narrow masks are per query: expand any dedup'd filter rows
                # on the host and drop mask_idx for this batch
                per_q = np.zeros((B, Nd), np.float32)
                per_q[:B_real] = np.stack(routed)
                if mask_idx is not None:
                    per_q *= base_mask[mask_idx].astype(np.float32)
                    mask_idx = None
                elif base_mask.ndim == 2:
                    per_q *= base_mask
                else:
                    per_q[B_real:] = 1.0
                    per_q *= base_mask[None, :]
                doc_mask = per_q.astype(np.float32)
            else:
                shadow_masks = routed
            trace["stages"]["topology_route_ms"] = (time.monotonic() - t_r) * 1e3

        hot = self._hot_device(Nd)
        t_dev = time.monotonic()
        lex_prefilter = (cfg.bm25_prefilter
                         if Nd > cfg.approx_threshold and cfg.bm25_prefilter > 0
                         else 0)
        if lex_prefilter and cfg.prefilter_max_tail_ratio > 0:
            tail = self.lexical_index.prefilter_tail_ratio(lex_prefilter)
            if tail > cfg.prefilter_max_tail_ratio:
                trace["prefilter_disabled_tail_ratio"] = round(tail, 3)
                lex_prefilter = 0
        use_packed = bm.packed is not None
        lexical = (bm.packed if use_packed else bm.postings_doc,
                   bm.impact_scale if use_packed else bm.postings_impact,
                   bm.term_offsets, bm.term_lengths)

        def to_dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        if use_pq:
            vv, vs = self._pq_candidates(_query_vecs, B_real, B, rrf_c, Nd,
                                         doc_mask, mask_idx, mode)
            vals, slots, bm_at, vec_at = hybrid_fuse_precomputed(
                to_dev(tids), to_dev(tmask), *lexical,
                to_dev(doc_mask), hot, to_dev(w), to_dev(vv), to_dev(vs),
                to_dev(mask_idx) if mask_idx is not None else None,
                k=k_dev,
                rrf_cand=rrf_c,
                window=self.lexical_index.config.postings_window,
                num_slots=Nd,
                bm25_prefilter=lex_prefilter,
                packed_lexical=use_packed,
            )
        elif narrow_gather is not None:
            # narrow gather tier: vector candidates from the routed rows,
            # fusion by the precomputed-candidates program (as the PQ tier)
            vv, vs = self._gather_candidates(_query_vecs(), E, *narrow_gather,
                                             B_real, B, rrf_c, Nd, cfg.chunk_agg)
            vals, slots, bm_at, vec_at = hybrid_fuse_precomputed(
                to_dev(tids), to_dev(tmask), *lexical,
                to_dev(doc_mask), hot, to_dev(w), to_dev(vv), to_dev(vs), None,
                k=k_dev,
                rrf_cand=rrf_c,
                window=self.lexical_index.config.postings_window,
                num_slots=Nd,
                bm25_prefilter=lex_prefilter,
                packed_lexical=use_packed,
            )
        else:
            rows = E.shape[0]
            flat = self.vector_index.identity_layout and rows >= Nd
            scale_opts: dict = {
                "int8_corpus": self.vector_index.device_dtype == "int8"}
            if lex_prefilter:
                scale_opts["bm25_prefilter"] = lex_prefilter
            if flat:
                scale_opts["rows_are_docs"] = True
                if (rows > cfg.streaming_threshold
                        and rows % cfg.streaming_block_rows == 0):
                    scale_opts["scan_block_rows"] = cfg.streaming_block_rows
                    trace["scan_block_rows"] = cfg.streaming_block_rows
                    # streaming indexes the mask by row, not slot: pad
                    pad = rows - doc_mask.shape[-1]
                    if pad > 0:
                        doc_mask = np.pad(
                            doc_mask, [(0, 0)] * (doc_mask.ndim - 1) + [(0, pad)])
            vals, slots, bm_at, vec_at = hybrid_query(
                to_dev(sketches.astype(np.float32)), to_dev(tids), to_dev(tmask),
                proj, E, row_valid, row2slot, row_scale, *lexical,
                to_dev(doc_mask), hot, to_dev(w),
                to_dev(mask_idx) if mask_idx is not None else None,
                k=k_dev,
                rrf_cand=rrf_c,
                window=self.lexical_index.config.postings_window,
                num_slots=Nd,
                chunk_agg=cfg.chunk_agg,
                packed_lexical=use_packed,
                **scale_opts,
            )
        vals, slots, bm_at, vec_at = (
            t[:B_real].cpu().numpy() for t in (vals, slots, bm_at, vec_at))

        # late-interaction rerank (ColBERT tier): MaxSim over the fused
        # candidates' token embeddings, blended into the fused score
        if (self.token_index is not None and mode == "hybrid"
                and self.token_index.doc_count > 0):
            t_li = time.monotonic()
            Tq = self.config.late_interaction_max_tokens
            qt = np.zeros((B_real, Tq, self.provider.dim), np.float32)
            qm = np.zeros((B_real, Tq), np.float32)
            for i, q in enumerate(queries):
                tv = self.provider.encode_tokens(q, max_tokens=Tq)
                n = min(len(tv), Tq)
                if n:
                    qt[i, :n] = tv[:n]
                    qm[i, :n] = 1.0
            li = self._maxsim(self.token_index, qt, qm, slots)
            vals, slots, bm_at, vec_at = _blend(vals, slots, bm_at, vec_at,
                                                cfg.late_interaction_weight, li)
            trace["stages"]["late_interaction_ms"] = (time.monotonic() - t_li) * 1e3
        # fragment-geometry rerank arm: MaxSim over the candidates' SENTENCE
        # embeddings, blended like the ColBERT tier
        if (self.fragment_index is not None and mode == "hybrid"
                and self.fragment_index.doc_count > 0):
            t_fg = time.monotonic()
            qv = self.provider.encode(list(queries[:B_real]))[:, None, :]
            fg = self._maxsim(self.fragment_index, qv, np.ones((B_real, 1), np.float32), slots)
            vals, slots, bm_at, vec_at = _blend(vals, slots, bm_at, vec_at,
                                                self.config.fragment_geometry_weight, fg)
            trace["stages"]["fragment_geometry_ms"] = (time.monotonic() - t_fg) * 1e3
        trace["stages"]["device_ms"] = (time.monotonic() - t_dev) * 1e3

        # shadow policy: how often narrow routing would have agreed, and the
        # per-construction miss-risk certificate (protected candidates = the
        # production top-k; a miss = one the shadow route would have dropped)
        if shadow_masks is not None:
            agree = []
            calib = self._route_calib
            for i in range(B_real):
                top = [int(s) for s, v in zip(slots[i], vals[i]) if v > -1e29][:k]
                if top:
                    covered = sum(shadow_masks[i][s] > 0 for s in top)
                    agree.append(covered / len(top))
                    calib["queries"] += 1
                    calib["protected"] += len(top)
                    calib["missed"] += len(top) - covered
            if agree:
                prev = self._stats["topology_shadow_agree"]
                cur = float(np.mean(agree))
                self._stats["topology_shadow_agree"] = (
                    0.9 * prev + 0.1 * cur if self._stats["searches"] else cur
                )
                trace["shadow_agreement"] = cur
            if cfg.topology_auto_promote and self._maybe_promote_narrow():
                trace["topology_promoted"] = True

        # entity-vector leg: ONE device search for the whole batch
        kg_leg = bool(self.kg) and mode == "hybrid"
        ev_hits = self._entity_vector_batch(queries, qvecs=_query_vecs) if kg_leg else None
        out: list[list[SearchResult]] = []
        n_slots_used = len(self._doc_by_slot)
        kg_w = self.config.kg_weight
        doc_by_slot = self._doc_by_slot
        titles = self._titles
        for i, (vi, si, bi, ci) in enumerate(zip(vals.tolist(), slots.tolist(),
                                                 bm_at.tolist(), vec_at.tolist())):
            qtext = queries[i]
            kg_scores = self._kg_scores(qtext, ev_hits[i]) if kg_leg else {}
            results: list[SearchResult] = []
            for j, v in enumerate(vi):
                if v <= -1e29:
                    break
                slot = si[j]
                if slot >= n_slots_used:
                    continue
                doc_id = doc_by_slot[slot]
                kg_s = kg_scores.get(doc_id, 0.0)
                results.append(SearchResult(
                    doc_id=doc_id, score=v + kg_w * kg_s if kg_scores else v,
                    text_score=bi[j], vector_score=ci[j], kg_score=kg_s,
                    title=titles.get(doc_id, "")))
            if kg_scores:
                results.sort(key=lambda r: -r.score)
            if kg_leg and self.config.graph_rerank_enabled:
                self._graph_rerank(results)
            if self.cross_reranker is not None and mode == "hybrid":
                # optional cross-encoder hook (reference: setCrossReranker)
                results = self.cross_reranker(qtext, results[: k * 2])
            if (self.config.semantic_rescue_slots > 0 and mode == "hybrid"
                    and len(results) > k):
                self._semantic_rescue(results, k)
            out.append(results[:k])
        with self._lock:  # searches may run concurrently
            self._stats["searches"] += len(queries)
            self._stats["total_ms"] += (time.monotonic() - t0) * 1e3
        trace["total_ms"] = (time.monotonic() - t0) * 1e3
        self.last_trace = trace
        return out

    def _maxsim(self, index, q_tok: np.ndarray, q_mask: np.ndarray,
                slots: np.ndarray) -> np.ndarray:
        """MaxSim of host query tokens against the candidate slots' rows of a
        TokenIndex, gathered and scored on the device -> (B, C) host f32."""
        dev = self.device
        cand_tok, cand_mask = index.gather(torch.from_numpy(slots).to(dev))
        return maxsim_scores(torch.from_numpy(q_tok).to(dev), torch.from_numpy(q_mask).to(dev),
                             cand_tok, cand_mask).cpu().numpy()

    # -- knowledge-graph leg -------------------------------------------------------
    def add_entity_vectors(self, node_ids: list[int], labels: list[str]) -> None:
        """Embed KG node labels into the entity-vector side index (slot ==
        kg node id). Idempotent: re-indexing a node replaces its row."""
        if not node_ids:
            return
        vecs = self.provider.encode(labels)
        for nid in node_ids:
            self.entity_index.remove_doc(nid)
        self.entity_index.add(vecs, node_ids)

    def _entity_vector_batch(self, queries: list[str], qvecs=None):
        """Entity-vector similarities for ALL queries in one device search:
        -> per-query [(node_id, sim), ...]; empty lists when the side index
        is empty. qvecs: the query embeddings, or a zero-arg callable giving
        them (search_batch passes its per-batch memo)."""
        if self.entity_index.active_rows == 0:
            return [[] for _ in queries]
        if qvecs is None:
            qvecs = self.provider.encode(queries)
        elif callable(qvecs):
            qvecs = qvecs()
        vals, rows = self.entity_index.search(qvecs, k=4)
        out = []
        for i in range(len(queries)):
            node_ids = self.entity_index.slots_of_rows(rows[i])
            out.append([
                (int(n), float(s)) for s, n in zip(vals[i], node_ids)
                if s >= 0.4 and n >= 0
            ])
        return out

    def _semantic_rescue(self, results: list[SearchResult], k: int) -> None:
        """Guarantee at least `semantic_rescue_slots` of the final top-k
        carry vector evidence by promoting the best-vector tail candidates
        over the weakest non-semantic window occupants. Bounded: at most
        `slots` swaps, never displacing a semantic occupant."""
        cfg = self.config
        window = min(k, len(results))
        target = min(cfg.semantic_rescue_slots, window)
        is_sem = lambda r: r.vector_score > cfg.semantic_rescue_min_vector  # noqa: E731
        present = sum(1 for r in results[:window] if is_sem(r))
        while present < target:
            tail = [i for i in range(window, len(results))
                    if is_sem(results[i])]
            if not tail:
                break
            best_tail = max(tail, key=lambda i: results[i].vector_score)
            victims = [i for i in range(window - 1, -1, -1)
                       if not is_sem(results[i])]
            if not victims:
                break
            victim = victims[0]
            results[victim], results[best_tail] = \
                results[best_tail], results[victim]
            present += 1
        results[:window] = sorted(results[:window], key=lambda r: -r.score)

    def _community_support(self, doc_ids: list[int]) -> list[float]:
        """Reciprocal-community support over the candidate window.
        Candidates link via shared KG entities (directed top-N neighbor
        lists, weight = sum of min confidences); reciprocal pairs form
        communities; members of a community of size m get support
        (m-1)/(reference_size-1), clamped to [0,1]."""
        cfg = self.config
        n = len(doc_ids)
        support = [0.0] * n
        if n < 2:
            return support
        if not self.kg.has_doc_entities():
            return support
        ents_map = self.kg.entities_for_documents(doc_ids)
        ents = [
            {nid: conf for nid, _t, conf in ents_map.get(d, ())}
            for d in doc_ids
        ]
        if not any(ents):
            return support
        out_w: list[dict[int, float]] = [{} for _ in range(n)]
        for a in range(n):
            if not ents[a]:
                continue
            sims = []
            for b in range(n):
                if a == b or not ents[b]:
                    continue
                shared = ents[a].keys() & ents[b].keys()
                if not shared:
                    continue
                w = sum(min(ents[a][s], ents[b][s]) for s in shared)
                if w >= cfg.graph_community_min_edge_weight:
                    sims.append((w, b))
            for w, b in heapq.nlargest(cfg.graph_max_neighbors, sims):
                out_w[a][b] = w
        adj: list[list[int]] = [[] for _ in range(n)]
        for a in range(n):
            for b in out_w[a]:
                if b > a and a in out_w[b]:
                    adj[a].append(b)
                    adj[b].append(a)
        denom = (cfg.graph_community_reference_size - 1.0
                 if cfg.graph_community_reference_size > 1.0 else n - 1.0)
        seen = [False] * n
        for i in range(n):
            if seen[i] or not adj[i]:
                continue
            comp, stack = [], [i]
            seen[i] = True
            while stack:
                cur = stack.pop()
                comp.append(cur)
                for nb in adj[cur]:
                    if not seen[nb]:
                        seen[nb] = True
                        stack.append(nb)
            if len(comp) < 2:
                continue
            s = min(1.0, (len(comp) - 1) / max(denom, 1.0))
            for m in comp:
                support[m] = max(support[m], s)
        return support

    def _graph_rerank(self, results: list[SearchResult]) -> None:
        """Guarded multiplicative KG boost of the fused top window.
        Composite signal = entity signal blended with reciprocal-community
        support; corroborated by the lexical anchor, decayed by a 1/sqrt
        rank prior, capped by graph_rerank_max_boost; falls back to
        boosting the single top signal when nothing clears the gate."""
        cfg = self.config
        window = min(len(results), cfg.graph_rerank_top_n)
        if window < 2:
            return
        cand = results[:window]
        # no doc<->entity links and no query-matched entities: no boost can
        # clear the gate, so the pass is a no-op resort
        if (not self.kg.has_doc_entities()
                and all(r.kg_score <= 0.0 for r in cand)):
            return
        community = self._community_support([r.doc_id for r in cand])
        base_w = max(0.0, 1.0 - cfg.graph_community_weight)
        raw, anchors = [], []
        # lexical-anchor normalizer: fixed divisor when configured, else the
        # window's own max text score
        bm_div = cfg.bm25_norm_divisor if cfg.bm25_norm_divisor > 0 else \
            max((max(r.text_score, 0.0) for r in cand), default=0.0) or 1e-6
        for i, r in enumerate(cand):
            entity = min(max(r.kg_score, 0.0), 1.0)
            raw.append(min(1.0, entity * base_w
                           + community[i] * cfg.graph_community_weight))
            anchors.append(min(max(r.text_score, 0.0) / bm_div, 1.0))
        max_raw = max(raw)
        max_anchor = max(anchors)
        boosted = False
        top_i = max(range(window), key=lambda i: raw[i])
        for i, r in enumerate(cand):
            if raw[i] < cfg.graph_rerank_min_signal or raw[i] <= 0.0:
                continue
            normalized = raw[i] / max_raw if max_raw > 0 else 0.0
            effective = min(1.0, raw[i] * 0.6 + normalized * 0.4)
            anchor_ratio = anchors[i] / max_anchor if max_anchor > 0 else 0.0
            corroboration = min(1.0, cfg.graph_corroboration_floor
                                + (1.0 - cfg.graph_corroboration_floor)
                                * anchor_ratio)
            guarded = effective * corroboration / math.sqrt(1.0 + i)
            boost = min(cfg.graph_rerank_max_boost,
                        cfg.graph_rerank_weight * guarded)
            if boost <= 0.0:
                continue
            r.score *= (1.0 + boost)
            r.kg_score += boost
            boosted = True
        if (not boosted and cfg.graph_fallback_to_top_signal
                and raw[top_i] > 0.0):
            fb = min(cfg.graph_rerank_max_boost * 0.5,
                     cfg.graph_rerank_weight * raw[top_i])
            if fb > 0:
                cand[top_i].score *= (1.0 + fb)
                cand[top_i].kg_score += fb
        results.sort(key=lambda r: -r.score)

    def _kg_scores(self, query: str, ev_hits=()) -> dict[int, float]:
        """Host KG leg: exact alias matches + entity-vector similarity, both
        mapped to linked docs. ev_hits come pre-batched from
        _entity_vector_batch."""
        scores: dict[int, float] = {}
        if not self.kg.has_doc_entities():
            # nothing can map to a doc: skip the per-token alias lookups
            return scores
        toks = tokenize(query)[:8]
        for tok in toks:
            for node in self.kg.resolve_alias(tok, limit=4):
                for doc_id, conf in self.kg.documents_for_node(node, limit=20):
                    scores[doc_id] = max(scores.get(doc_id, 0.0), conf)
        # bigram-concept aliases: a query containing a concept's surface
        # phrase scores its linked docs at concept_weight
        cw = self.config.concept_weight
        if cw > 0:
            for a, b in zip(toks, toks[1:]):
                for node in self.kg.resolve_alias(f"{a} {b}", limit=2):
                    for doc_id, conf in self.kg.documents_for_node(
                            node, limit=20):
                        scores[doc_id] = max(scores.get(doc_id, 0.0),
                                             cw * conf)
        ev_scale = (self.config.entity_vector_weight
                    / max(self.config.kg_weight, 1e-6))
        for node, sim in ev_hits:
            for doc_id, conf in self.kg.documents_for_node(node, limit=20):
                boost = sim * conf * ev_scale
                scores[doc_id] = max(scores.get(doc_id, 0.0), boost)
        return scores

    def stats(self) -> dict:
        s = dict(self._stats)
        s["vector"] = self.vector_index.stats()
        s["lexical"] = self.lexical_index.stats()
        if s["searches"]:
            s["avg_latency_ms"] = s["total_ms"] / s["searches"]
        return s
