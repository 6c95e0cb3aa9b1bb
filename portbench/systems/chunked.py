"""Chunked-store cells: the port's dense-tier query program on a store of
several embedding rows (segments) a document, made on the device from the
seed.

The timed call is `yams_tpu_torch.search.fusion.hybrid_query` with the
arguments `SearchEngine.search_batch` passes it for such a store: what
`VectorIndex.device_arrays()` holds (E at its capacity rows, the padding
rows zero, invalid and at row2slot -1), the doc mask over
`num_slots_padded` slots (ones over the used ones), a zero hot vector, the
packed lexical leg with its prefilter over the document slots, the weights
packed by the port's own `pack_weights`, and the configuration's
`chunk_agg`. No `rows_are_docs` and no `scan_block_rows`: `search_batch`
takes the flat and streaming paths only for one row a document, so the
chunked path scores every row and folds the chunk scores into document
scores before the mask and the selection. Everything else (the traffic,
the answers' copies, the sample judged) is `systems/hybrid.py`'s.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .. import data
from ..peaks import bound
from ..reference import chunked as refc
from ..reference import hybrid as ref
from . import hybrid


def request_bound(config: dict, B: int, C: int, K: int, take: int, terms: int,
                  T: int) -> dict:
    """The least time one request needs, over the valid segments alone (the
    padding rows are waste): each input read once, each output written
    once: the segments (bf16 rows, validity, row2slot), the doc mask over
    the used documents, the projection, the sketches and term lists, the
    prefiltered postings of the batch's `terms` distinct terms, the hot
    entries of the 2C candidates, the four (B, K) answers. Operations: the
    embed and the segments' scores, bf16, two a multiply-add."""
    R, D, S = config["rows"], config["dim"], config["sketch_dim"]
    nbytes = (R * (D * 2 + 4 + 4) + shapes(config)[0] + S * D * 2 + B * S * 4 + B * T * 8
              + terms * take * 4 + B * 2 * C * 4 + B * K * 16)
    return bound(nbytes, {"bf16": 2.0 * B * S * D + 2.0 * B * R * D})


def shapes(config: dict) -> tuple[int, int, int]:
    """(docs, capacity, num_slots) of a store of `rows` segments, as the
    configuration file states them: the documents the rows hold at the
    corpus's published segments a document (rounded half up), the rows
    `VectorIndex` grows to (its 16,384 doubled until the rows fit), and
    `SearchEngine.num_slots_padded` (1,024 doubled until the docs fit)."""
    R, pub = config["rows"], config["published"]
    docs = (2 * R * pub["docs"] + pub["segments"]) // (2 * pub["segments"])
    capacity, num_slots = 1 << 14, 1 << 10
    while capacity < R:
        capacity *= 2
    while num_slots < docs:
        num_slots *= 2
    return docs, capacity, num_slots


def segment_counts(gen: torch.Generator, device, docs: int, rows: int,
                   sigma: float) -> torch.Tensor:
    """(docs,) int64 segments a document, summing to `rows`: one each, and
    the other rows - docs drawn one by one over the documents in proportion
    to log-normal (sigma) weights (a multinomial draw)."""
    w = torch.exp(sigma * torch.randn(docs, generator=gen, device=device, dtype=torch.float64))
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(rows - docs, generator=gen, device=device, dtype=torch.float64)
    pick = torch.searchsorted(cdf, u).clamp_max_(docs - 1)
    return 1 + torch.bincount(pick, minlength=docs)


def packed_postings(device, docs: int, num_slots: int, lex: dict) -> tuple[torch.Tensor,
                                                                           torch.Tensor]:
    """`data.packed_postings` over the used document slots: term t's posting
    c names doc ((t * per_term + c) * 2654435761 mod 2**32) mod `docs`; the
    key layout and the sink are those of `num_slots` documents, as the
    engine packs its postings for `num_slots_padded`."""
    V, WIN, per_term = lex["terms"], lex["postings_window"], lex["postings_per_term"]
    vmax = float(lex["impact_max"])
    qbits = data.packed_qbits(num_slots)
    qmax = (1 << qbits) - 1
    tt = torch.arange(V, device=device, dtype=torch.int64)[:, None]
    cc = torch.arange(WIN, device=device, dtype=torch.int64)[None, :]
    doc = (((tt * per_term + cc) * data.HASH) & 0xFFFFFFFF) % docs
    q = torch.clamp(torch.round(data.impacts(cc, lex) * (qmax / vmax)), 0, qmax).long()
    packed = torch.where(cc < per_term, (doc << qbits) | q, num_slots << qbits).to(torch.int32)
    return packed, torch.tensor(vmax, dtype=torch.float32, device=device)


class Cell(hybrid.Cell):
    """One chunked configuration under one traffic mix, built from the seed."""

    def __init__(self, config: dict, mix: dict, seed: int, device, engine=None):
        from yams_tpu_torch.search import fusion

        del engine                      # a chunked store takes no streaming settings
        if config["dtype"] != "bf16":
            raise ValueError(f"dtype {config['dtype']!r}: the chunked cells are bf16")
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self._hybrid_query = fusion.hybrid_query
        R, D, S = config["rows"], config["dim"], config["sketch_dim"]
        docs, cap, num_slots = shapes(config)
        corpus, lex, search = config["corpus"], config["lexical"], mix["search"]
        B = mix["batch"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)

        # the index, as VectorIndex.device_arrays() holds it: a document's
        # segments on contiguous rows, documents in slot order, padding after
        counts = segment_counts(gen, device, docs, R, config["segments"]["sigma"])
        row2slot = torch.full((cap,), -1, dtype=torch.int32, device=device)
        row2slot[:R] = torch.repeat_interleave(
            torch.arange(docs, dtype=torch.int32, device=device), counts)
        del counts
        centers = data.unit_centers(gen, device, corpus["centers"], D)
        E = torch.zeros(cap, D, dtype=torch.bfloat16, device=device)
        for lo in range(0, R, corpus["block_rows"]):
            hi = min(R, lo + corpus["block_rows"])
            E[lo:hi] = data.clustered_rows(gen, centers, lo, hi, corpus["sigma"])
        del centers
        doc_mask = torch.zeros(num_slots, dtype=torch.uint8, device=device)
        doc_mask[:docs] = 1
        packed, impact_scale = packed_postings(device, docs, num_slots, lex)
        V, per_term = lex["terms"], lex["postings_per_term"]
        rows = ref.Inputs(
            dtype="bf16", E=E, row_scale=torch.ones(cap, dtype=torch.float32, device=device),
            row_valid=(row2slot >= 0).float(), doc_mask=doc_mask,
            hot=torch.zeros(num_slots, dtype=torch.float32, device=device),
            proj=data.sign_projection(gen, device, S, D),
            packed=packed, impact_scale=float(impact_scale.item()),
            qbits=data.packed_qbits(num_slots), weights=dict(config["fusion"]))
        self.inputs = rows
        self.store = refc.store(rows, row2slot)
        self._row2slot = row2slot
        self._lexical = (packed, impact_scale,
                         torch.arange(V, dtype=torch.int32, device=device) * per_term,
                         torch.full((V,), per_term, dtype=torch.int32, device=device))
        self._weights = torch.from_numpy(
            fusion.pack_weights(types.SimpleNamespace(**config["fusion"]))).to(device)

        # the query pool, cycled by the window
        self.batch = B
        self.n_batches = mix["pool_batches"]
        self.sketches, self.tids, self.tmask = data.query_pool(
            gen, device, B * self.n_batches, S, V, mix["query"])

        window = lex["postings_window"]
        self.kw = dict(k=search["device_k"], rrf_cand=search["rrf_cand"], window=window,
                       num_slots=num_slots, chunk_agg=config["chunk_agg"],
                       bm25_prefilter=search["bm25_prefilter"], packed_lexical=True,
                       int8_corpus=False)
        prefilter = search["bm25_prefilter"]
        self.params = ref.Params(C=search["rrf_cand"], K=search["device_k"],
                                 take=prefilter if 0 < prefilter < window else window)
        self._bounds = [self._bound(j) for j in range(self.n_batches)]

    def describe(self) -> str:
        c = self.config
        docs, cap, num_slots = shapes(c)
        kw = {k: v for k, v in self.kw.items() if k != "num_slots"}
        return (f"{c['rows']} segments of {docs} documents on {cap} x {c['dim']} bf16 rows, "
                f"{num_slots} slots, B {self.batch}, pool {self.n_batches} batches, "
                f"hybrid_query {kw}")

    def _bound(self, j: int) -> dict:
        r = slice(j * self.batch, (j + 1) * self.batch)
        terms = torch.unique(self.tids[r][self.tmask[r] > 0]).numel()
        p = self.params
        return request_bound(self.config, self.batch, p.C, p.K, p.take, terms,
                             self.tids.shape[1])

    def judge(self, answers: list, requests: list[int], eps: dict, precision: str = "config"):
        """As `hybrid.Cell.judge`, by the chunked reference: the documents'
        exact scores the max of their segments'."""
        sk, ti, tm = self.queries_of(requests)
        prog = [np.concatenate([answers[i][n] for i in requests]) for n in range(4)]
        p = self.params
        refs = refc.reference(self.store, sk, ti, tm, p)
        if precision != "config":
            ctrl = refc.reference(self.store, sk, ti, tm, p, precision)
        numbers: dict[str, float] = {}
        lo = 0
        for k, r in enumerate(refs):
            hi = lo + r.vec_v.shape[0]
            got = (ctrl[k].outputs if precision != "config"
                   else tuple(a[lo:hi] for a in prog))
            part = ref.judge(self.store.docs, r, got, p, eps["vec"], eps["bm25"])
            for name, v in part.items():
                numbers[name] = max(numbers.get(name, 0.0), v)
            lo = hi
        return numbers, sk.shape[0]
