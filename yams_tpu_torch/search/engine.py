"""SearchEngine on torch: the dense hybrid tier of yams_tpu's engine.

Port of yams_tpu/search/engine.py for the path a first search takes:
`add_document(s)` (host tokenization, Simeon embeddings, index updates),
`search` / `search_batch` on the dense tier (search_batch's default branch,
engine.py:592-1020) and the result glue (:1137-1216). The host state is
yams_tpu's own VectorIndex / LexicalIndex (subclassed for their torch device
views), so both engines hold identical state for identical adds.

Not ported, and refused loudly (NotImplementedError) rather than skipped:
topology routing, the KG and graph legs, the search tuner, the PQ tier,
sharded serving, the narrow gather tier, late interaction (ColBERT) and
fragment geometry, intent-adaptive weighting and semantic rescue. The
hotzone (feedback) state is not ported either: its boost vector is zero.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from yams_tpu.core.config import EmbeddingConfig, LexicalIndexConfig, VectorIndexConfig
from yams_tpu.embed.chunker import chunk_document

from ..device import resolve_device
from ..embed.provider import SimeonProvider
from ..index.lexical_index import LexicalIndex
from ..index.vector_index import VectorIndex
from .config import SearchEngineConfig
from .fusion import W_TEXT, W_VEC, hybrid_query, pack_weights


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


class SearchEngine:
    def __init__(
        self,
        config: SearchEngineConfig | None = None,
        embedding: EmbeddingConfig | None = None,
        vector: VectorIndexConfig | None = None,
        lexical: LexicalIndexConfig | None = None,
        *,
        device: str | torch.device,
    ):
        self.device = resolve_device(device)
        self.config = config or SearchEngineConfig()
        self.provider = SimeonProvider(embedding, device=self.device)
        vcfg = vector or VectorIndexConfig(dim=self.provider.dim)
        if str(vcfg.engine) != "dense" or vcfg.dtype != "bfloat16":
            raise NotImplementedError(
                f"vector engine {vcfg.engine!r}/{vcfg.dtype!r}: only dense bf16 is ported")
        self.vector_config = vcfg
        self.vector_index = VectorIndex(
            dim=self.provider.dim,
            capacity=vcfg.capacity,
            block_rows=vcfg.block_rows,
            space_id=self.provider.space_id,
        )
        self.lexical_index = LexicalIndex(lexical)
        self.last_trace: dict | None = None
        # doc identity: external doc_id <-> dense slot
        self._slot_by_doc: dict[int, int] = {}
        self._doc_by_slot: list[int] = []
        self._titles: dict[int, str] = {}
        self._lock = threading.RLock()

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
        if chunk_strategy == "semantic":
            raise NotImplementedError("semantic chunking is not ported")
        all_texts: list[str] = []
        vec_slots: list[int] = []
        counts: list[int] = []
        for doc_id, content, title in docs:
            slot = self._slot_for(doc_id)
            with self._lock:
                self._titles[doc_id] = title
            self.vector_index.remove_doc(slot)
            self.lexical_index.add_document(slot, content, title)
            texts = [c.text for c in chunk_document(content, chunk_strategy)]
            if title:
                texts = [title] + texts
            counts.append(len(texts))
            all_texts.extend(texts)
            vec_slots.extend([slot] * len(texts))
        if all_texts:
            self.vector_index.add(self.provider.encode(all_texts), vec_slots)
        return counts

    # -- search ---------------------------------------------------------------------
    def search(self, query: str, k: int = 10, mode: str = "hybrid",
               filter_doc_ids: set[int] | None = None,
               intent: str | None = None) -> list[SearchResult]:
        return self.search_batch([query], k, mode, filter_doc_ids, intent)[0]

    def _refuse_unported(self, cfg, mode, intent) -> None:
        if cfg.tuner_enabled:
            raise NotImplementedError("search tuner is not ported")
        if cfg.pq_tier_enabled and self.vector_index.has_pq:
            raise NotImplementedError("PQ capacity tier is not ported")
        if cfg.topology_policy not in ("off", "shadow"):
            # "shadow" without a topology build is "off" in the reference
            raise NotImplementedError(
                f"topology policy {cfg.topology_policy!r} is not ported")
        if (intent is not None and cfg.intent_adaptive
                and mode not in ("keyword", "vector")):
            raise NotImplementedError("intent-adaptive weighting is not ported")
        if cfg.semantic_rescue_slots > 0:
            raise NotImplementedError("semantic rescue slots are not ported")

    def search_batch(
        self,
        queries: list[str],
        k: int = 10,
        mode: str = "hybrid",
        filter_doc_ids: set[int] | None = None,
        intent: str | None = None,
        per_query_filters: list[set[int] | None] | None = None,
    ) -> list[list[SearchResult]]:
        """Batched hybrid search on the dense tier (see yams_tpu's
        SearchEngine.search_batch for the argument contract)."""
        t0 = time.monotonic()
        trace: dict = {"query_count": len(queries), "mode": mode, "stages": {}}
        if not self._doc_by_slot:
            return [[] for _ in queries]
        cfg = self.config
        self._refuse_unported(cfg, mode, intent)
        dev = self.device
        Nd = self.num_slots_padded
        B_real = len(queries)
        B = max(cfg.batch_pad, _round_pow2(B_real, floor=cfg.batch_pad))
        rrf_c = min(max(cfg.rrf_candidates, k), Nd)
        k_dev = min(max(k * 2, cfg.rrf_candidates), 2 * rrf_c)

        sketches, proj = self.provider.query_device_inputs(queries)
        sketches = np.pad(np.asarray(sketches), ((0, B - B_real), (0, 0)))
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

        E, row_valid, row2slot, row_scale = self.vector_index.device_arrays(dev)
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
            doc_mask = np.zeros((U, Nd), np.uint8)
            doc_mask[: len(rows)] = np.stack(rows)
            mask_idx = idx
        else:
            doc_mask = _mask_of(filter_doc_ids)

        # hotzone boosts come from the feedback surface, which is not ported
        hot = torch.zeros(Nd, dtype=torch.float32, device=dev)
        t_dev = time.monotonic()
        lex_prefilter = (cfg.bm25_prefilter
                         if Nd > cfg.approx_threshold and cfg.bm25_prefilter > 0
                         else 0)
        if lex_prefilter and cfg.prefilter_max_tail_ratio > 0:
            tail = self.lexical_index.prefilter_tail_ratio(lex_prefilter)
            if tail > cfg.prefilter_max_tail_ratio:
                trace["prefilter_disabled_tail_ratio"] = round(tail, 3)
                lex_prefilter = 0
        rows = E.shape[0]
        flat = self.vector_index.identity_layout and rows >= Nd
        scale_opts: dict = {}
        if lex_prefilter:
            scale_opts["bm25_prefilter"] = lex_prefilter
        if flat:
            scale_opts["rows_are_docs"] = True
            if (rows > cfg.streaming_threshold
                    and rows % cfg.streaming_block_rows == 0):
                scale_opts["scan_block_rows"] = cfg.streaming_block_rows
        use_packed = bm.packed is not None

        def to_dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        vals, slots, bm_at, vec_at = hybrid_query(
            to_dev(sketches.astype(np.float32)), to_dev(tids), to_dev(tmask),
            proj, E, row_valid, row2slot, row_scale,
            bm.packed if use_packed else bm.postings_doc,
            bm.impact_scale if use_packed else bm.postings_impact,
            bm.term_offsets, bm.term_lengths,
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
        trace["stages"]["device_ms"] = (time.monotonic() - t_dev) * 1e3

        out: list[list[SearchResult]] = []
        n_slots_used = len(self._doc_by_slot)
        doc_by_slot = self._doc_by_slot
        titles = self._titles
        for vi, si, bi, ci in zip(vals.tolist(), slots.tolist(),
                                  bm_at.tolist(), vec_at.tolist()):
            results: list[SearchResult] = []
            for j, v in enumerate(vi):
                if v <= -1e29:
                    break
                slot = si[j]
                if slot >= n_slots_used:
                    continue
                doc_id = doc_by_slot[slot]
                results.append(SearchResult(
                    doc_id=doc_id, score=v, text_score=bi[j],
                    vector_score=ci[j], title=titles.get(doc_id, "")))
            out.append(results[:k])
        trace["total_ms"] = (time.monotonic() - t0) * 1e3
        self.last_trace = trace
        return out
