"""Hybrid search cells: the port's dense-tier query program on an index made
on the device from the seed.

The timed call is `yams_tpu_torch.search.fusion.hybrid_query` with the
arguments `SearchEngine.search_batch` passes it on the dense tier for a
flat index (rows are docs): the packed lexical leg with its prefilter, an
all-ones doc mask, a zero hot vector, the weights packed by the port's own
`pack_weights`, and `scan_block_rows` when the port's `SearchEngineConfig()`
would stream this many rows. What changes results (k, the candidates a leg,
the prefilter, the weights) is the cell's data; what only chooses how the
work is done (`streaming_threshold`, `streaming_block_rows`, `chunk_agg`) is
read from the port's `SearchEngineConfig()` when the cell is built. A
request ends when its four (B, k) answers are on the host, copied one by one
as `search_batch` copies them.
"""

from __future__ import annotations

import random
import types

import numpy as np
import torch

from .. import data
from ..peaks import bound
from ..reference import hybrid as ref


def request_bound(config: dict, B: int, C: int, K: int, take: int, terms: int,
                  T: int) -> dict:
    """The least time one request needs. Each input read once, each output
    written once: the corpus (and its row scales for int8), the validity
    and doc mask, the projection, the sketches and term lists, the
    prefiltered postings of the batch's `terms` distinct terms, the hot
    entries of the 2C candidates, the four (B, K) answers. Operations: the
    embed (bf16) and the scores (in the corpus' dtype), two a multiply-add."""
    N, D, S = config["rows"], config["dim"], config["sketch_dim"]
    int8 = config["dtype"] == "int8"
    nbytes = (N * D * (1 if int8 else 2) + (N * 4 if int8 else 0) + N * 4 + N
              + S * D * 2 + B * S * 4 + B * T * 8 + terms * take * 4
              + B * 2 * C * 4 + B * K * 16)
    ops = {"bf16": 2.0 * B * S * D}
    ops[config["dtype"]] = ops.get(config["dtype"], 0.0) + 2.0 * B * N * D
    return bound(nbytes, ops)


class Cell:
    """One configuration under one traffic mix, built from the seed."""

    def __init__(self, config: dict, mix: dict, seed: int, device, engine=None):
        from yams_tpu_torch.search import fusion
        from yams_tpu_torch.search.config import SearchEngineConfig

        engine = engine if engine is not None else SearchEngineConfig()
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self._hybrid_query = fusion.hybrid_query
        N, D, S = config["rows"], config["dim"], config["sketch_dim"]
        corpus, lex, search = config["corpus"], config["lexical"], mix["search"]
        B = mix["batch"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)

        # the index, as the engine holds it on the device
        if config["dtype"] == "int8":
            E, row_scale = data.clustered_int8(gen, device, N, D, corpus["centers"],
                                               corpus["sigma"], corpus["block_rows"])
        elif config["dtype"] == "bf16":
            E = data.clustered_bf16(gen, device, N, D, corpus["centers"], corpus["sigma"],
                                    corpus["block_rows"])
            row_scale = torch.ones(N, dtype=torch.float32, device=device)
        else:
            raise ValueError(f"dtype {config['dtype']!r}")
        packed, impact_scale = data.packed_postings(device, N, lex)
        V, per_term = lex["terms"], lex["postings_per_term"]
        self.inputs = ref.Inputs(
            dtype=config["dtype"], E=E, row_scale=row_scale,
            row_valid=torch.ones(N, dtype=torch.float32, device=device),
            doc_mask=torch.ones(N, dtype=torch.uint8, device=device),
            hot=torch.zeros(N, dtype=torch.float32, device=device),
            proj=data.sign_projection(gen, device, S, D),
            packed=packed, impact_scale=float(impact_scale.item()),
            qbits=data.packed_qbits(N), weights=dict(config["fusion"]))
        self._lexical = (packed, impact_scale,
                         torch.arange(V, dtype=torch.int32, device=device) * per_term,
                         torch.full((V,), per_term, dtype=torch.int32, device=device))
        self._row2slot = torch.arange(N, dtype=torch.int32, device=device)
        self._weights = torch.from_numpy(
            fusion.pack_weights(types.SimpleNamespace(**config["fusion"]))).to(device)

        # the query pool, cycled by the window
        self.batch = B
        self.n_batches = mix["pool_batches"]
        self.sketches, self.tids, self.tmask = data.query_pool(
            gen, device, B * self.n_batches, S, V, mix["query"])

        window = lex["postings_window"]
        self.kw = dict(k=search["device_k"], rrf_cand=search["rrf_cand"], window=window,
                       num_slots=N, chunk_agg=engine.chunk_agg, rows_are_docs=True,
                       bm25_prefilter=search["bm25_prefilter"], packed_lexical=True,
                       int8_corpus=config["dtype"] == "int8")
        if N > engine.streaming_threshold and N % engine.streaming_block_rows == 0:
            self.kw["scan_block_rows"] = engine.streaming_block_rows
        prefilter = search["bm25_prefilter"]
        self.params = ref.Params(C=search["rrf_cand"], K=search["device_k"],
                                 take=prefilter if 0 < prefilter < window else window)
        self._bounds = [self._bound(j) for j in range(self.n_batches)]

    def describe(self) -> str:
        kw = {k: v for k, v in self.kw.items() if k != "num_slots"}
        return (f"{self.config['rows']} x {self.config['dim']} {self.config['dtype']}, "
                f"B {self.batch}, pool {self.n_batches} batches, hybrid_query {kw}")

    # -- the timed path ---------------------------------------------------------
    def _rows(self, i: int) -> slice:
        j = i % self.n_batches
        return slice(j * self.batch, (j + 1) * self.batch)

    def request(self, i: int):
        """Request i: pool batch i mod n, through the program, answers on the host."""
        r = self._rows(i)
        inp = self.inputs
        out = self._hybrid_query(
            self.sketches[r], self.tids[r], self.tmask[r], inp.proj, inp.E, inp.row_valid,
            self._row2slot, inp.row_scale, *self._lexical, inp.doc_mask, inp.hot,
            self._weights, **self.kw)
        return tuple(t.cpu().numpy() for t in out)

    def warm(self, n: int):
        """The window's one shape, n times, from the end of the pool."""
        for i in range(n):
            self.request(self.n_batches - 1 - i)

    # -- the least time a request needs ---------------------------------------------
    def _bound(self, j: int) -> dict:
        r = slice(j * self.batch, (j + 1) * self.batch)
        terms = torch.unique(self.tids[r][self.tmask[r] > 0]).numel()
        p = self.params
        return request_bound(self.config, self.batch, p.C, p.K, p.take, terms,
                             self.tids.shape[1])

    def bound_s(self, i: int) -> float:
        return self._bounds[i % self.n_batches]["bound_s"]

    def bound_of(self, i: int) -> dict:
        return self._bounds[i % self.n_batches]

    # -- correctness ----------------------------------------------------------------
    def sample(self, done: list[int]) -> list[int]:
        """Requests to judge, drawn from the seed among those completed
        (`done`): up to `sample_requests`, of distinct pool batches."""
        rng = random.Random(self.seed ^ 0x5EED)
        order = list(done)
        rng.shuffle(order)
        picked, seen = [], set()
        for i in order:
            if i % self.n_batches not in seen:
                seen.add(i % self.n_batches)
                picked.append(i)
            if len(picked) == self.mix["sample_requests"]:
                break
        return sorted(picked)

    def queries_of(self, requests: list[int]):
        rows = [self._rows(i) for i in requests]
        return tuple(torch.cat([t[r] for r in rows]) for t in (self.sketches, self.tids, self.tmask))

    def judge(self, answers: list, requests: list[int], eps: dict, precision: str = "config"):
        """The comparison's numbers over the requests' answers (each the
        program's four host arrays), the reference at the configuration's
        precision working every number out again. With precision="lower"
        the answers judged are the control's instead, computed here."""
        sk, ti, tm = self.queries_of(requests)
        prog = [np.concatenate([answers[i][n] for i in requests]) for n in range(4)]
        p = self.params
        refs = ref.reference(self.inputs, sk, ti, tm, p)
        if precision != "config":
            ctrl = ref.reference(self.inputs, sk, ti, tm, p, precision)
        numbers: dict[str, float] = {}
        lo = 0
        for k, r in enumerate(refs):
            hi = lo + r.vec_v.shape[0]
            got = (ctrl[k].outputs if precision != "config"
                   else tuple(a[lo:hi] for a in prog))
            part = ref.judge(self.inputs, r, got, p, eps["vec"], eps["bm25"])
            for name, v in part.items():
                numbers[name] = max(numbers.get(name, 0.0), v)
            lo = hi
        return numbers, sk.shape[0]
