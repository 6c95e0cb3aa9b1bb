"""Plain reference of the hybrid query on a chunked store, and its control.

Plain PyTorch only: this module imports nothing of the program. A chunked
store holds several embedding rows (segments) a document; `row2slot` names
each row's document slot, -1 on padding. The vector leg ranks documents by
their best segment (MaxP, the configuration's `chunk_agg` "max"):

  2'. each segment's exact score (`reference/hybrid.py`'s arithmetic at the
      precision asked: f64 for the configuration's, the fp8 product for the
      control), in blocks of rows and of queries, and each document's score
      the max over its segments (-inf for a slot with none); plus
      (has a segment - 1) * 1e30 and (doc mask - 1) * 1e30; the top C.

Everything else (the embed, the lexical leg over the document slots, the
fusion, the judge) is `reference/hybrid.py`'s, handed the documents
(`Store.docs`) as its rows: a max is exact in any order, so each document's
exact score is one segment's exact score, and the judge's distances mean
what they mean there.
"""

from __future__ import annotations

import dataclasses

import torch

from . import hybrid as ref


@dataclasses.dataclass
class Store:
    """What the benchmark made for a chunked cell."""

    rows: ref.Inputs          # the segments: E (capacity, D), row_scale, row_valid;
                              # and the proj, postings and weights the legs share
    row2slot: torch.Tensor    # (capacity,) int32, -1 on padding
    docs: ref.Inputs          # the documents as the legs after aggregation see them


def store(rows: ref.Inputs, row2slot: torch.Tensor) -> Store:
    """The store of segments `rows` laid out by `row2slot` over the
    documents of `rows.doc_mask` and `rows.hot` (num_slots,). The
    documents' `E` is a zero-width (num_slots, 0) tensor: the lexical leg,
    the fusion and the judge read only its length and device (and no row
    scale); a document is valid where it has a segment."""
    num_slots = rows.doc_mask.shape[0]
    seg = row2slot.long()
    has = torch.zeros(num_slots + 1, dtype=torch.float32, device=row2slot.device)
    has[torch.where(seg < 0, num_slots, seg)] = 1.0
    docs = dataclasses.replace(rows, E=rows.E.new_empty((num_slots, 0)),
                               row_valid=has[:num_slots])
    return Store(rows, row2slot, docs)


class DocVectors:
    """The vector leg over documents: (Q, num_slots) f64 document scores,
    each the max of its segments' exact scores at one precision."""

    def __init__(self, st: Store, q: torch.Tensor, precision: str):
        vec = ref._Vectors(st.rows, q, precision)
        num_slots = st.docs.E.shape[0]
        n = st.rows.E.shape[0]
        seg = st.row2slot.long()
        seg = torch.where(seg < 0, num_slots, seg)            # padding to a sink column
        table = torch.full((q.shape[0], num_slots + 1), -torch.inf, dtype=torch.float64,
                           device=q.device)
        for lo in range(0, n, ref.ROW_BLOCK):
            hi = min(n, lo + ref.ROW_BLOCK)
            s = vec.block_scores(lo, hi)
            table.scatter_reduce_(1, seg[lo:hi][None, :].expand_as(s), s, reduce="amax")
            del s
        self.q = vec.q
        self.table = table[:, :num_slots]

    def scores_at(self, ids: torch.Tensor) -> torch.Tensor:
        """(Q, n) scores of the documents `ids` (Q, n) of each query."""
        return self.table.gather(1, ids)


def reference(st: Store, sketch, tids, tmask, p: ref.Params,
              precision: str = "config") -> list[ref.Reference]:
    """The whole query over (Q, ...) queries, in blocks of QUERY_BLOCK."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return [_reference(st, sketch[lo:lo + ref.QUERY_BLOCK], tids[lo:lo + ref.QUERY_BLOCK],
                           tmask[lo:lo + ref.QUERY_BLOCK], p, precision)
                for lo in range(0, sketch.shape[0], ref.QUERY_BLOCK)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _reference(st: Store, sketch, tids, tmask, p: ref.Params, precision: str) -> ref.Reference:
    depth = p.C + ref.DEPTH
    docs = st.docs
    vec = DocVectors(st, ref.embed(sketch, docs.proj), precision)
    vv, vi = torch.topk(vec.table + ref._biases(docs, slice(None))[None, :], depth, dim=1)
    lex = ref.lexical(docs, tids, tmask, p.take, depth, precision)
    dt = torch.float64 if precision == "config" else torch.bfloat16
    lw, out = ref.fuse(docs, lex, vv, vi, p.C, p.K, dt)
    return ref.Reference(vec, vv, vi, lex, lw, out)
