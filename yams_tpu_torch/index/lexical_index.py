"""Lexical (BM25) index whose device view is torch tensors.

Tokenization, postings maintenance, the CSR build (`build_arrays`), the
prefilter tail-ratio guard and the query-side term vectors are yams_tpu's
LexicalIndex, inherited. `device_arrays` is overridden to pack and upload
torch tensors to an explicit device, and `prefilter_tail_ratio` to reuse the
current build.
"""

from __future__ import annotations

import numpy as np
import torch

from yams_tpu.index.lexical_index import LexicalIndex as _ReferenceIndex

from ..ops.bm25 import Bm25Arrays, pack_postings_2d


class LexicalIndex(_ReferenceIndex):
    def __init__(self, config=None):
        super().__init__(config)
        self._torch_view: tuple | None = None  # ((n, device), Bm25Arrays)

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
        width a build was made for."""
        with self._lock:
            if self._dirty or self._arrays is None:
                self.build_arrays(self._num_slots or 1)
            arrs = self._arrays
            key = (id(arrs), prefilter)
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

    def search(self, query: str, k: int = 10):
        raise NotImplementedError("LexicalIndex.search (dense BM25 oracle) is not ported")
