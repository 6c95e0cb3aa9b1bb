"""Host-built, device-scanned lexical (BM25) index with torch device views.

Copied from yams_tpu/index/lexical_index.py as a class of its own:
tokenization and the namespaced strategy fields, the inverted postings map
with per-term caches, the CSR build (`build_arrays`), the query-side term
vectors and the per-query arm router. What the port adds:

  - `device_arrays(num_slots, device)` packs and uploads torch tensors to an
    explicit device (the packed (V, window) matrix rides along when
    V * window fits the budget), cached per (width, device) until a
    mutation;
  - `prefilter_tail_ratio` reads the current CSR build instead of
    rebuilding it on every call (the statistic reads only offsets, lengths
    and impacts, which do not depend on the doc-space width);
  - `load` unpickles plain containers and numbers only (`_PlainUnpickler`):
    `save` writes nothing else, so either package reads the other's
    lexical.pkl, and a file that names any class is refused.

`save`, `load`, `df_view` and the concept miner (`mine_concepts`,
`docs_with_bigram`, which the repair service's `concepts` op runs) are the
reference's. The dense BM25 oracle `search` is not copied: nothing in the
port reaches it.
"""

from __future__ import annotations

import json
import pathlib
import pickle
import threading

import numpy as np
import torch

from ..core.config import LexicalIndexConfig
from ..embed.simeon import light_stem, tokenize
from ..ops.bm25 import Bm25Arrays, pack_postings_2d


class _PlainUnpickler(pickle.Unpickler):
    """Builds dicts, lists, strings and numbers; refuses every global."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"lexical.pkl names {module}.{name}")


class LexicalIndex:
    def __init__(self, config: LexicalIndexConfig | None = None):
        self.config = config or LexicalIndexConfig()
        self._vocab: dict[str, int] = {}
        # doc_slot -> {term_id: weighted tf}
        self._docs: dict[int, dict[int, float]] = {}
        self._doc_len: dict[int, float] = {}
        # inverted map + per-term packed caches (incremental rebuilds)
        self._postings: dict[int, dict[int, float]] = {}
        # light-stem -> surface term ids (query-side morphological expansion)
        self._stem_index: dict[str, list[int]] = {}
        self._dirty_terms: set[int] = set()
        self._term_cache: dict[int, tuple] = {}  # tid -> (slots, tf, part) desc
        self._built_avg_len: float = 0.0
        self._dirty = True
        self._arrays = None
        self._torch_view: tuple | None = None  # ((num_slots, device), Bm25Arrays)
        self._arrays_gen = 0  # bumps on every build_arrays
        self._tail_ratio_cache: tuple | None = None  # ((arrays gen, pf), ratio)
        self._num_slots = 0
        self._lock = threading.RLock()

    # -- mutation -----------------------------------------------------------
    def _term_id(self, term: str) -> int:
        tid = self._vocab.get(term)
        if tid is None:
            tid = len(self._vocab)
            self._vocab[term] = tid
            self._stem_index.setdefault(light_stem(term), []).append(tid)
        return tid

    # field-token namespaces (never collide with tokenize() output, which is
    # lowercase alnum): bigram "a\x1fb", lead "\x02tok", subword "\x03tri"
    BIGRAM_SEP = "\x1f"
    LEAD_NS = "\x02"
    SUB_NS = "\x03"

    def _emit_fields(self, tf: dict[int, float], toks_by_field) -> None:
        """Fold strategy-field tokens into the SAME postings structure
        (SimeonLexicalBackend analog — see LexicalIndexConfig.field_*).
        Field tokens add tf entries only; they never contribute to doc_len,
        so plain unigram BM25 scoring is bit-identical with fields on."""
        cfg = self.config
        if cfg.field_bigrams:
            n_bi = 0
            for toks, weight in toks_by_field:
                for a, b in zip(toks, toks[1:]):
                    if n_bi >= cfg.max_bigrams_per_doc:
                        break
                    if len(a) < 3 or len(b) < 3:
                        continue  # stopword-ish short tokens make noise pairs
                    tid = self._term_id(a + self.BIGRAM_SEP + b)
                    tf[tid] = tf.get(tid, 0.0) + weight
                    n_bi += 1
        if cfg.field_lead:
            lead: list[str] = []
            for toks, _w in toks_by_field:  # title first, then content
                lead.extend(toks[: cfg.lead_tokens - len(lead)])
                if len(lead) >= cfg.lead_tokens:
                    break
            for tok in set(lead):
                tid = self._term_id(self.LEAD_NS + tok)
                tf[tid] = tf.get(tid, 0.0) + 1.0
        if cfg.field_subword:
            seen_toks: set[str] = set()
            for toks, weight in toks_by_field:
                for tok in toks:
                    if (len(tok) < cfg.subword_min_len or tok in seen_toks
                            or len(seen_toks) >= cfg.subword_max_doc_tokens):
                        continue
                    seen_toks.add(tok)
                    for i in range(min(len(tok) - 2,
                                       cfg.subword_tris_per_token)):
                        tid = self._term_id(self.SUB_NS + tok[i:i + 3])
                        tf[tid] = tf.get(tid, 0.0) + weight

    def add_document(self, doc_slot: int, content: str, title: str = "") -> None:
        cfg = self.config
        tf: dict[int, float] = {}
        n_tokens = 0.0
        toks_by_field: list[tuple[list[str], float]] = []
        for text, weight in ((title, cfg.title_weight), (content, cfg.content_weight)):
            if not text:
                continue
            toks = list(tokenize(text))
            toks_by_field.append((toks, weight))
            for tok in toks:
                tid = self._term_id(tok)
                tf[tid] = tf.get(tid, 0.0) + weight
                n_tokens += weight
        if cfg.field_bigrams or cfg.field_lead or cfg.field_subword:
            self._emit_fields(tf, toks_by_field)
        with self._lock:
            old = self._docs.get(doc_slot)
            if old:
                for tid in old:
                    self._postings.get(tid, {}).pop(doc_slot, None)
                    self._dirty_terms.add(tid)
            self._docs[doc_slot] = tf
            self._doc_len[doc_slot] = n_tokens
            for tid, f in tf.items():
                self._postings.setdefault(tid, {})[doc_slot] = f
                self._dirty_terms.add(tid)
            self._num_slots = max(self._num_slots, doc_slot + 1)
            self._dirty = True

    def remove_document(self, doc_slot: int) -> bool:
        with self._lock:
            if doc_slot in self._docs:
                for tid in self._docs[doc_slot]:
                    self._postings.get(tid, {}).pop(doc_slot, None)
                    self._dirty_terms.add(tid)
                del self._docs[doc_slot]
                del self._doc_len[doc_slot]
                self._dirty = True
                return True
            return False

    @property
    def doc_count(self) -> int:
        return len(self._docs)

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    # -- build ----------------------------------------------------------------
    def _refresh_term(self, tid: int, doc_norm: np.ndarray, k1: float) -> None:
        """Rebuild one term's packed (slots, tf, part) cache, part-descending.

        `part` is the idf-free BM25 factor tf*(k1+1)/(tf+k1*doc_norm); the
        per-term idf scalar multiplies in at pack time so corpus growth never
        dirties clean terms."""
        plist = self._postings.get(tid)
        if not plist:
            self._term_cache[tid] = (
                np.empty(0, np.int32), np.empty(0, np.float32),
                np.empty(0, np.float32),
            )
            return
        slots = np.fromiter(plist.keys(), np.int32, len(plist))
        tf = np.fromiter(plist.values(), np.float32, len(plist))
        part = tf * (k1 + 1.0) / (tf + k1 * doc_norm[np.minimum(slots, len(doc_norm) - 1)])
        order = np.argsort(-part, kind="stable")
        self._term_cache[tid] = (slots[order], tf[order], part[order])

    def build_arrays(self, num_slots: int | None = None) -> dict:
        """(Re)build CSR postings: only dirty terms re-sort; the pack is a
        numpy concatenation of per-term caches."""
        with self._lock:
            cfg = self.config
            N = max(num_slots or self._num_slots, 1)
            window = cfg.postings_window
            V = max(len(self._vocab), 1)
            k1 = cfg.k1
            n_docs = max(len(self._docs), 1)
            avg_len = (sum(self._doc_len.values()) / n_docs) if self._docs else 1.0
            avg_len = max(avg_len, 1e-9)

            doc_norm = np.ones(N, np.float32)
            for slot, ln in self._doc_len.items():
                if slot < N:
                    doc_norm[slot] = 1.0 - cfg.b + cfg.b * ln / avg_len

            # cached `part` factors bake doc_norm: drift >10% forces a full
            # refresh (the reference's periodic index rebuild)
            if self._built_avg_len and abs(avg_len - self._built_avg_len) \
                    > 0.1 * self._built_avg_len:
                self._dirty_terms.update(self._postings.keys())
            self._built_avg_len = avg_len
            for tid in self._dirty_terms:
                self._refresh_term(tid, doc_norm, k1)
            self._dirty_terms.clear()

            offs = np.zeros(V, np.int32)
            lens = np.zeros(V, np.int32)
            idf = np.zeros(V, np.float32)
            chunks_d: list[np.ndarray] = []
            chunks_t: list[np.ndarray] = []
            chunks_i: list[np.ndarray] = []
            pos = 0
            empty = (np.empty(0, np.int32), np.empty(0, np.float32),
                     np.empty(0, np.float32))
            for v in range(V):
                slots, tf, part = self._term_cache.get(v, empty)
                df = len(slots)
                idf[v] = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
                take = min(df, window)
                offs[v] = pos
                lens[v] = take
                chunks_d.append(slots[:take])
                chunks_t.append(tf[:take])
                chunks_i.append(idf[v] * part[:take])
                pos += take
            # pad so any dynamic_slice window is in-bounds
            chunks_d.append(np.full(window, N, np.int32))
            chunks_t.append(np.zeros(window, np.float32))
            chunks_i.append(np.zeros(window, np.float32))

            self._arrays = {
                "postings_doc": np.concatenate(chunks_d).astype(np.int32),
                "postings_tf": np.concatenate(chunks_t).astype(np.float32),
                "postings_impact": np.concatenate(chunks_i).astype(np.float32),
                "term_offsets": offs,
                "term_lengths": lens,
                "doc_norm": doc_norm,
                "idf": idf,
                "num_docs": N,
            }
            self._arrays_gen += 1
            self._dirty = False
            return self._arrays

    def device_arrays(self, num_slots: int | None, device: torch.device):
        """Bm25Arrays on `device` for a `num_slots`-wide doc space; the packed
        (V, window) matrix rides along when V*window fits the budget."""
        with self._lock:
            want_n = max(num_slots or self._num_slots, 1)
            key = (want_n, device)
            if (not self._dirty and self._torch_view is not None
                    and self._torch_view[0] == key):
                return self._torch_view[1]
            self._torch_view = None
            arrs = self.build_arrays(want_n)
            window = self.config.postings_window
            packed = scale = None
            if len(arrs["term_offsets"]) * window <= self.config.packed_max_entries:
                pk, sc = pack_postings_2d(
                    arrs["postings_doc"], arrs["postings_impact"],
                    arrs["term_offsets"], arrs["term_lengths"],
                    window=window, num_docs=arrs["num_docs"],
                )
                packed = torch.from_numpy(pk).to(device)
                scale = torch.tensor(sc, dtype=torch.float32, device=device)

            def up(name):
                return torch.from_numpy(arrs[name]).to(device, copy=True)

            view = Bm25Arrays(
                postings_doc=up("postings_doc"),
                postings_impact=up("postings_impact"),
                term_offsets=up("term_offsets"),
                term_lengths=up("term_lengths"),
                num_docs=arrs["num_docs"],
                packed=packed,
                impact_scale=scale,
            )
            self._torch_view = (key, view)
            return view

    def prefilter_tail_ratio(self, prefilter: int) -> float:
        """The reference's impact-skew statistic (LexicalIndex
        .prefilter_tail_ratio), computed from the current CSR build instead
        of rebuilding it: the reference re-packs every term on each call,
        ~0.6 s per search at a 120k-term lexicon. The statistic reads only
        offsets, lengths and impacts, which do not depend on the doc-space
        width a build was made for. Cached per (build generation,
        prefilter): the reference keys its cache on id() of the arrays
        dict, which a later build can reuse, and then returns a stale
        ratio."""
        with self._lock:
            if self._dirty or self._arrays is None:
                self.build_arrays(self._num_slots or 1)
            arrs = self._arrays
            key = (self._arrays_gen, prefilter)
            if self._tail_ratio_cache and self._tail_ratio_cache[0] == key:
                return self._tail_ratio_cache[1]
            lens = arrs["term_lengths"]
            long_rows = lens > prefilter
            if not long_rows.any():
                ratio = 0.0
            else:
                o = arrs["term_offsets"][long_rows].astype(np.int64)
                pi = arrs["postings_impact"]
                ratio = float(np.mean(pi[o + prefilter] / np.maximum(pi[o], 1e-9)))
            self._tail_ratio_cache = (key, ratio)
            return ratio

    # -- query helpers -----------------------------------------------------------
    def query_term_ids(
        self, query: str, max_terms: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """query text -> (term_ids (T,), weights (T,)) padded to max_query_terms.

        Weights are fractional: exact vocab matches score 1.0; with
        stem_expansion on, same-stem vocab variants of each query token fill
        the remaining slots at stem_expansion_weight (the BM25 kernels scale
        each term's contribution by its weight). This closes the classic
        morphological query/document mismatch (query "routing" vs doc
        "routed") without touching the index or the compiled program."""
        cfg = self.config
        T = max_terms or cfg.max_query_terms
        ids = np.zeros(T, np.int32)
        mask = np.zeros(T, np.float32)
        qtoks = tokenize(query)
        n = 0
        seen: set[int] = set()
        for t in qtoks:
            tid = self._vocab.get(t)
            if tid is not None and tid not in seen and n < T:
                ids[n] = tid
                mask[n] = 1.0
                seen.add(tid)
                n += 1
        if cfg.stem_expansion and n < T:
            for t in qtoks:
                for vid in self._stem_index.get(light_stem(t), ()):
                    if vid in seen:
                        continue
                    if n >= T:
                        break
                    ids[n] = vid
                    mask[n] = cfg.stem_expansion_weight
                    seen.add(vid)
                    n += 1
                if n >= T:
                    break
        return ids, mask

    # -- strategy arms (SimeonLexicalBackend analog) ---------------------------
    ARMS = ("bm25", "sab_smooth", "keyphrase", "lead_field")

    def query_arm_terms(
        self, query: str, arm: str = "auto", max_terms: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray, str]:
        """(term_ids, weights, arm_used) for a lexical strategy arm.

        Every arm reuses the SAME device kernel and postings tensor; only the
        query-side term vector differs (reference: per-strategy score paths,
        simeon_lexical_backend.cpp:1073-1122):
          - bm25        — unigrams (+stem expansion), identical to
                          query_term_ids
          - sab_smooth  — bm25 terms, plus char-trigram backoff terms at
                          weight 1/γ for query tokens with NO vocab or stem
                          match (SubwordAwareBackoff γ=5)
          - keyphrase   — bm25 terms, plus in-vocab adjacent query bigrams at
                          bigram_weight
          - lead_field  — bm25 terms, plus lead-window tokens at lead_weight
        "auto" routes per query via route_arm()."""
        cfg = self.config
        if arm == "auto":
            arm = self.route_arm(query)
        T = max_terms or cfg.max_query_terms
        ids, mask = self.query_term_ids(query, max_terms=T)
        n = int((mask > 0).sum())
        qtoks = list(tokenize(query))

        def _add(term: str, w: float) -> None:
            nonlocal n
            tid = self._vocab.get(term)
            if tid is None or n >= T or tid in ids[:n]:
                return
            ids[n] = tid
            mask[n] = w
            n += 1

        if arm == "sab_smooth" and cfg.field_subword:
            w_tri = 1.0 / max(cfg.subword_gamma, 1.0)
            for tok in qtoks:
                if len(tok) < cfg.subword_min_len:
                    continue
                if tok in self._vocab or self._stem_index.get(light_stem(tok)):
                    continue  # vocab/stem coverage wins; backoff is for OOV
                for i in range(min(len(tok) - 2, cfg.subword_tris_per_token)):
                    _add(self.SUB_NS + tok[i:i + 3], w_tri)
        elif arm == "keyphrase" and cfg.field_bigrams:
            for a, b in zip(qtoks, qtoks[1:]):
                _add(a + self.BIGRAM_SEP + b, cfg.bigram_weight)
        elif arm == "lead_field" and cfg.field_lead:
            for tok in qtoks:
                _add(self.LEAD_NS + tok, cfg.lead_weight)
        else:
            arm = "bm25"
        return ids, mask, arm

    def mine_concepts(self, top_n: int = 256, min_df: int = 3,
                      min_pmi: float = 0.3) -> list[tuple[str, str, float, int]]:
        """PMI-based word-bigram concept mining over the corpus (reference:
        simeon_lexical_backend.h:140-150 concept_mining — discovers bigram
        concepts whose components co-occur far above chance).

        Zero extra passes: the bigram FIELD postings already carry df(ab);
        PMI(a,b) = log( p(ab) / (p(a) p(b)) ) with probabilities over docs.
        Returns [(a, b, pmi, df)] sorted by pmi*log(df) (a frequent strong
        concept beats a rare perfect one), capped at top_n."""
        import math

        n_docs = max(len(self._docs), 1)
        out: list[tuple[str, str, float, int]] = []
        with self._lock:
            for term, tid in self._vocab.items():
                if self.BIGRAM_SEP not in term:
                    continue
                a, b = term.split(self.BIGRAM_SEP, 1)
                df_ab = len(self._postings.get(tid, ()))
                if df_ab < min_df:
                    continue
                ta, tb = self._vocab.get(a), self._vocab.get(b)
                if ta is None or tb is None:
                    continue
                df_a = len(self._postings.get(ta, ()))
                df_b = len(self._postings.get(tb, ()))
                if not df_a or not df_b:
                    continue
                pmi = math.log(df_ab * n_docs / (df_a * df_b))
                if pmi >= min_pmi:
                    out.append((a, b, pmi, df_ab))
        out.sort(key=lambda t: -(t[2] * math.log1p(t[3])))
        return out[:top_n]

    def docs_with_bigram(self, a: str, b: str) -> dict[int, float]:
        """doc_slot -> tf for one bigram concept (for KG linking)."""
        tid = self._vocab.get(a + self.BIGRAM_SEP + b)
        if tid is None:
            return {}
        with self._lock:
            return dict(self._postings.get(tid, ()))

    def route_arm(self, query: str) -> str:
        """Cheap per-query profile -> arm (the host analog of the reference's
        EntropyRouter over query BM25-score entropy, retrieval_strategy.hpp;
        the SearchTuner bandit then learns per corpus profile whether routed
        arms actually pay)."""
        cfg = self.config
        qtoks = list(tokenize(query))
        if not qtoks:
            return "bm25"
        if cfg.field_subword:
            oov = [
                t for t in qtoks
                if len(t) >= cfg.subword_min_len and t not in self._vocab
                and not self._stem_index.get(light_stem(t))
            ]
            if oov:
                return "sab_smooth"
        if cfg.field_bigrams and len(qtoks) >= 2:
            if any(
                (a + self.BIGRAM_SEP + b) in self._vocab
                for a, b in zip(qtoks, qtoks[1:])
            ):
                return "keyphrase"
        if cfg.field_lead and len(qtoks) == 1:
            # single rare-term navigational query: lead placement is the
            # strongest signal (title/opening mention). Two-term queries are
            # NOT routed here — on real text (camel-split symbol queries)
            # lead boosts early *mentions* over definitions and measurably
            # hurt hybrid MRR; measured in docs/RESULTS.md (r5 arm eval)
            n_docs = max(len(self._docs), 1)
            dfs = [
                len(self._postings.get(self._vocab[t], ()))
                for t in qtoks if t in self._vocab
            ]
            if dfs and all(df <= max(4, n_docs // 20) for df in dfs):
                return "lead_field"
        return "bm25"

    # -- persistence -----------------------------------------------------------------
    def save(self, directory: str | pathlib.Path) -> None:
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        with self._lock, open(d / "lexical.pkl", "wb") as f:
            pickle.dump(
                {"vocab": self._vocab, "docs": self._docs, "doc_len": self._doc_len,
                 "num_slots": self._num_slots},
                f,
            )
        (d / "lexical.json").write_text(
            json.dumps({"docs": len(self._docs), "vocab": len(self._vocab)})
        )

    @classmethod
    def load(
        cls, directory: str | pathlib.Path, config: LexicalIndexConfig | None = None
    ) -> "LexicalIndex":
        idx = cls(config)
        with open(pathlib.Path(directory) / "lexical.pkl", "rb") as f:
            state = _PlainUnpickler(f).load()
        idx._vocab = state["vocab"]
        for term, tid in idx._vocab.items():
            idx._stem_index.setdefault(light_stem(term), []).append(tid)
        idx._docs = state["docs"]
        idx._doc_len = state["doc_len"]
        idx._num_slots = state["num_slots"]
        # rebuild the inverted map; every term starts dirty
        for slot, tf in idx._docs.items():
            for tid, f in tf.items():
                idx._postings.setdefault(tid, {})[slot] = f
        idx._dirty_terms.update(idx._postings.keys())
        idx._dirty = True
        return idx

    def df_view(self):
        """dict-like term -> document frequency (for PMI-ranked PRF)."""
        idx = self

        class _Df:
            def get(self, term, default=0):
                tid = idx._vocab.get(term)
                if tid is None:
                    return default
                return len(idx._postings.get(tid, {})) or default

        return _Df()

    def stats(self) -> dict:
        return {"docs": len(self._docs), "vocab": len(self._vocab)}
