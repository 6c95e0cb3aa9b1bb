"""Plain reference of the hybrid query, its lower-precision control, and the
comparison that judges the program's answers by it.

Plain PyTorch only: this module imports nothing of the program, and works
every number out again from the inputs the benchmark made (the corpus, its
row scales, the packed postings, the projection, the queries, the weights).

The query, as the configuration states it:
  1. embed: bf16(sketch) x bf16(proj), L2-normalized; the bf16 corpus takes
     the query rounded to bf16, the int8 corpus the query quantized per row
     to int8 (absmax / 127, round half to even);
  2. vector leg: each row's score (exact here: f64, or the int8 product's
     exact integer sum times the two scales), plus (valid - 1) * 1e30 and
     (doc mask - 1) * 1e30; the top C by score;
  3. lexical leg: each query term's first `take` packed postings (doc in the
     key's high bits, quantized impact in the low), the impact times the
     term weight truncated, summed per doc (exact integer sums here); the
     top C by sum, ties to the lower doc id;
  4. fusion of the two lists: adaptive leg weights, normalized scores plus
     rrf_scale / (rrf_k + rank + 1), the vector-only penalty, the hot boost;
     the top K by fused value.

The control (`precision="lower"`) is the same query one step below the
configuration's precision: an fp8 (e4m3, per-row scaled) product for a bf16
corpus, an int4 product for an int8 one, and the lexical sums and the
fusion in bf16 where the configuration states f32.

`judge` compares a program's (or the control's) answers with the reference
at the configuration's precision. Near-ties make more than one answer
right, so each number measures how far an answer lies from the set of right
ones, never from one canonical list:
  vec_gap        the larger of |reported vector score - exact score of
                 that slot| and how far a slot reported in the vector top C
                 lies below the exact C-th score (or one reported outside it
                 lies above it)
  bm25_gap       the same for the lexical sums and the lexical top C
  fused_gap      how far a reported fused value lies outside the interval of
                 the fused values its slot can rightly take: each leg's rank
                 anywhere among the docs whose exact scores lie within the
                 tie tolerance of its own
  fused_miss     how far a doc that belongs in the fused top K at its lowest
                 right value lies above the lowest value reported, where it
                 is not reported
"""

from __future__ import annotations

import dataclasses

import torch

NEG = -1e30
FP8_MAX = 448.0          # largest finite float8 e4m3fn
ROW_BLOCK = 131072       # corpus rows a block of the reference's scan
QUERY_BLOCK = 1024       # queries a block
DEPTH = 64               # list entries kept past the top C, for the tie intervals


@dataclasses.dataclass
class Inputs:
    """What the benchmark made, handed to the program and to the reference."""

    dtype: str                 # "bf16" | "int8"
    E: torch.Tensor            # (N, D) bf16, or int8 codes
    row_scale: torch.Tensor    # (N,) f32 (int8 dequantization; ones for bf16)
    row_valid: torch.Tensor    # (N,) f32
    doc_mask: torch.Tensor     # (N,) uint8
    hot: torch.Tensor          # (N,) f32
    proj: torch.Tensor         # (S, D) bf16
    packed: torch.Tensor       # (V, window) int32 keys
    impact_scale: float
    qbits: int
    weights: dict              # the fusion's named weights


@dataclasses.dataclass
class Params:
    C: int                     # candidates a leg
    K: int                     # fused answers a query
    take: int                  # postings a term the lexical leg reads


# -- 1. embed -----------------------------------------------------------------
def embed(sketch: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(Q, S) f32 sketches -> (Q, D) f64 unit queries: bf16 operands,
    products summed in f64."""
    q = sketch.to(torch.bfloat16).double() @ proj.double()
    return q / q.norm(dim=1, keepdim=True).clamp_min(1e-9)


def _quantize(x: torch.Tensor, levels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization to +-levels: (codes f32, scales f64)."""
    amax = x.abs().amax(dim=1).clamp_min(1e-12).double()
    scale = amax / levels
    return torch.round(x.double() / scale[:, None]).clamp_(-levels, levels).float(), scale


def _fp8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row scaled float8 e4m3 values (as f32) and their f64 scales."""
    scale = x.abs().amax(dim=-1).clamp_min(1e-12).double() / FP8_MAX
    v = (x.double() / scale[..., None]).float().to(torch.float8_e4m3fn).float()
    return v, scale


class _Vectors:
    """The vector leg's arithmetic at one precision: `query` once, then
    `scores(rows)` for any rows of the corpus, (Q, n) f64."""

    def __init__(self, inp: Inputs, q: torch.Tensor, precision: str):
        self.inp, self.precision = inp, precision
        if inp.dtype == "bf16" and precision == "config":
            self.q, self.qs = q.to(torch.bfloat16).double(), None
        elif inp.dtype == "bf16":
            self.q, self.qs = _fp8(q.float())
        elif inp.dtype == "int8":
            self.q, self.qs = _quantize(q, 127 if precision == "config" else 7)
        else:
            raise ValueError(f"dtype {inp.dtype!r}")

    def corpus(self, rows: torch.Tensor | slice):
        """(rows' values at this precision, f64 row scales or None)."""
        inp = self.inp
        if inp.dtype == "bf16" and self.precision == "config":
            return inp.E[rows].double(), None
        if inp.dtype == "bf16":
            return _fp8(inp.E[rows].float())
        e8 = inp.E[rows].float()
        es = inp.row_scale[rows].double()
        if self.precision == "config":
            return e8, es
        # int4 codes of the stored int8 rows: round(e8 * 7 / max|e8|)
        emax = e8.abs().amax(dim=-1).clamp_min(1.0)
        e4 = torch.round(e8 * (7.0 / emax[..., None])).clamp_(-7, 7)
        return e4, es * emax.double() / 7.0

    def block_scores(self, lo: int, hi: int) -> torch.Tensor:
        e, es = self.corpus(slice(lo, hi))
        s = (self.q.to(e.dtype) @ e.t()).double()
        if self.qs is not None:
            s *= self.qs[:, None]
        if es is not None:
            s *= es[None, :]
        return s

    def scores_at(self, ids: torch.Tensor) -> torch.Tensor:
        """(Q, n) scores of the rows `ids` (Q, n) of each query."""
        e, es = self.corpus(ids)                       # (Q, n, D)
        s = torch.einsum("qnd,qd->qn", e, self.q.to(e.dtype)).double()
        if self.qs is not None:
            s *= self.qs[:, None]
        if es is not None:
            s *= es
        return s


def _biases(inp: Inputs, rows) -> torch.Tensor:
    """(valid - 1) * 1e30 + (doc mask - 1) * 1e30 of the rows (f64)."""
    return ((inp.row_valid[rows].double() - 1.0) * 1e30
            + (inp.doc_mask[rows].double() - 1.0) * 1e30)


def vector_top(inp: Inputs, vec: _Vectors, depth: int):
    """(values (Q, depth) f64 descending, row ids (Q, depth) int64)."""
    N = inp.E.shape[0]
    Q = vec.q.shape[0]
    dev = inp.E.device
    vals = torch.full((Q, depth), -torch.inf, dtype=torch.float64, device=dev)
    ids = torch.zeros((Q, depth), dtype=torch.int64, device=dev)
    for lo in range(0, N, ROW_BLOCK):
        hi = min(N, lo + ROW_BLOCK)
        s = vec.block_scores(lo, hi) + _biases(inp, slice(lo, hi))[None, :]
        cand_v = torch.cat([vals, s], dim=1)
        cand_i = torch.cat([ids, torch.arange(lo, hi, device=dev).expand(Q, -1)], dim=1)
        del s
        vals, pos = torch.topk(cand_v, depth, dim=1)
        ids = cand_i.gather(1, pos)
    return vals, ids


# -- 3. lexical leg -------------------------------------------------------------
@dataclasses.dataclass
class Lexical:
    docs: torch.Tensor      # (Q, L) int64 doc ids ascending, padded with N
    sums: torch.Tensor      # (Q, L) f64 sums (0 at pads)
    top_v: torch.Tensor     # (Q, depth) f64 descending, ties to the lower doc
    top_i: torch.Tensor     # (Q, depth) int64 (N where empty)

    def at(self, ids: torch.Tensor) -> torch.Tensor:
        """(Q, n) sums of docs `ids` (0 for a doc no query term names)."""
        pos = torch.searchsorted(self.docs, ids).clamp_max_(self.docs.shape[1] - 1)
        return torch.where(self.docs.gather(1, pos) == ids, self.sums.gather(1, pos), 0.0)


def lexical(inp: Inputs, tids: torch.Tensor, tmask: torch.Tensor, take: int,
            depth: int, precision: str) -> Lexical:
    N = inp.E.shape[0]
    qmax = (1 << inp.qbits) - 1
    Q = tids.shape[0]
    keys = inp.packed[tids.long(), :take].long()                   # (Q, T, take)
    docs = keys >> inp.qbits
    w = tmask.double().clamp(0.0, 1.0)[:, :, None]
    q = torch.floor((keys & qmax).double() * w)
    live = (tmask[:, :, None] > 0) & (docs < N)
    docs = torch.where(live, docs, N).reshape(Q, -1)
    unit = inp.impact_scale / qmax
    if precision == "config":
        vals = torch.where(live, q, 0.0).reshape(Q, -1)
    else:
        vals = torch.where(live, q * unit, 0.0).reshape(Q, -1).to(torch.bfloat16)
    docs, order = docs.sort(dim=1, stable=True)
    vals = vals.gather(1, order)
    flat = (torch.arange(Q, device=docs.device)[:, None] * (N + 1) + docs).reshape(-1)
    uniq, inv = torch.unique_consecutive(flat, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=vals.dtype, device=docs.device)
    sums.index_add_(0, inv, vals.reshape(-1))
    if precision == "config":
        sums = sums * unit                                          # exact integer sums
    row = uniq // (N + 1)
    doc = uniq % (N + 1)
    start = torch.cumsum(torch.bincount(row, minlength=Q), 0) - torch.bincount(row, minlength=Q)
    col = torch.arange(uniq.shape[0], device=docs.device) - start[row]
    L = int(col.max().item()) + 1 if uniq.numel() else 1
    D_ = torch.full((Q, L), N, dtype=torch.int64, device=docs.device)
    S_ = torch.zeros((Q, L), dtype=torch.float64, device=docs.device)
    D_[row, col] = doc
    S_[row, col] = sums.double()
    S_ = torch.where(D_ < N, S_, 0.0)
    # ranked: value descending, doc ascending (a stable sort of doc-sorted rows)
    v, order = torch.sort(torch.where(D_ < N, S_, -1.0), dim=1, descending=True, stable=True)
    i = D_.gather(1, order)
    if v.shape[1] < depth:
        pad = depth - v.shape[1]
        v = torch.nn.functional.pad(v, (0, pad), value=-1.0)
        i = torch.nn.functional.pad(i, (0, pad), value=N)
    v, i = v[:, :depth], i[:, :depth]
    i = torch.where(v > 0, i, N)
    v = v.clamp_min(0.0)
    return Lexical(D_, S_, v, i)


# -- 4. fusion ------------------------------------------------------------------
@dataclasses.dataclass
class LegWeights:
    wt: torch.Tensor        # (Q, 1) text leg weight after adaptation
    wv: torch.Tensor        # (Q, 1) vector leg weight after adaptation
    bm_div: torch.Tensor    # (Q, 1)
    vec_qmax: torch.Tensor  # (Q, 1)


def leg_weights(w: dict, bm_v, bm_ok, vv, vec_ok) -> LegWeights:
    """The per-query adaptive leg weights and the two legs' normalizers,
    from each leg's C candidates (values descending)."""
    wt, wv = w["text_weight"], w["vector_weight"]
    bm_live = torch.where(bm_ok, bm_v, 0.0)
    bm_qmax = bm_live.amax(dim=1, keepdim=True)
    bm_div = (torch.full_like(bm_qmax, w["bm25_norm_divisor"])
              if w["bm25_norm_divisor"] > 0 else bm_qmax.clamp_min(1e-6))
    vec_clip = ((vv + w["vec_norm_bias"]) * w["vec_norm_scale"]).clamp(0.0, 1.0)
    vec_live = torch.where(vec_ok, vec_clip, 0.0)
    vec_qmax = vec_live.amax(dim=1, keepdim=True)

    def conf(live, ok, qmax):
        n = ok.sum(dim=1, keepdim=True).to(live.dtype)
        rel = (live / qmax.clamp_min(1e-6)).sum(dim=1, keepdim=True)
        c_mean = torch.where(n > 0, 1.0 - rel / n.clamp_min(1.0), 0.0)
        top = live[:, 1:8] / qmax.clamp_min(1e-6)
        c_margin = torch.where(n > 0, 1.0 - top.mean(dim=1, keepdim=True), 0.0)
        g = min(max(w["leg_conf_margin"], 0.0), 1.0)
        return (1.0 - g) * c_mean + g * c_margin

    mass_l = wt * conf(bm_live, bm_ok, bm_qmax)
    mass_v = wv * conf(vec_live, vec_ok, vec_qmax)
    mass = mass_l + mass_v
    leg_sum = wt + wv
    share_l = torch.where(mass > 1e-9, mass_l / mass.clamp_min(1e-9),
                          torch.full_like(mass, wt / max(leg_sum, 1e-9)))
    a = w["leg_adaptive"]
    return LegWeights((1.0 - a) * wt + a * leg_sum * share_l,
                      (1.0 - a) * wv + a * leg_sum * (1.0 - share_l), bm_div, vec_qmax)


def _vec_norm(w: dict, s, lw: LegWeights):
    clip = ((s + w["vec_norm_bias"]) * w["vec_norm_scale"]).clamp(0.0, 1.0)
    return clip if w["bm25_norm_divisor"] > 0 else clip / lw.vec_qmax.clamp_min(1e-6)


def fused_value(w: dict, lw: LegWeights, bm_in, bm, r_bm, vec_in, s, r_vec, hot):
    """Fused value of docs with lexical sum `bm` at rank r_bm (if bm_in) and
    vector score `s` at rank r_vec (if vec_in)."""
    rs, k = w["rrf_scale"], w["rrf_k"]
    v_bm = lw.wt * ((bm / lw.bm_div).clamp(0.0, 1.0) + rs / (k + r_bm + 1.0))
    v_vec = lw.wv * (_vec_norm(w, s, lw) + rs / (k + r_vec + 1.0))
    total = torch.where(bm_in, v_bm, 0.0) + torch.where(vec_in, v_vec, 0.0)
    total = torch.where(~bm_in & vec_in, total * w["vector_only_penalty"], total)
    return total + w["hotzone_weight"] * hot


def fuse(inp: Inputs, lex: Lexical, vv, vi, C: int, K: int, dt: torch.dtype):
    """The leg weights and the fused top K in the program's output contract:
    (values (Q, K) f32, slots (Q, K) int64, lexical sums (Q, K), vector
    scores (Q, K), -1 for a doc outside the vector list), computed in `dt`."""
    w = inp.weights
    N = inp.E.shape[0]
    Q = vv.shape[0]
    dev = vv.device
    bm_v, bm_i = lex.top_v[:, :C].to(dt), lex.top_i[:, :C]
    vv, vi = vv[:, :C].to(dt), vi[:, :C]
    mask = inp.doc_mask.to(dt)
    bm_ok = (bm_v > 0) & (bm_i < N) & (mask[bm_i.clamp_max(N - 1)] > 0) & (w["text_weight"] > 0)
    vec_ok = (vv > -1e29) & (w["vector_weight"] > 0)
    lw = leg_weights(w, bm_v, bm_ok, vv, vec_ok)
    ranks = torch.arange(C, device=dev, dtype=dt)[None, :].expand(Q, -1)
    # the union: each lexical candidate, then each vector candidate not in it
    same = (vi[:, :, None] == bm_i[:, None, :]) & bm_ok[:, None, :] & vec_ok[:, :, None]
    v_hit = same.any(dim=2)                                     # vector cand. also lexical
    b_hit = same.any(dim=1)                                     # lexical cand. also vector
    v_pos = same.to(torch.int64).argmax(dim=1)                  # vector rank of a lexical cand.
    zero = torch.zeros_like(bm_v)
    b_val = fused_value(w, lw, bm_ok, bm_v, ranks, b_hit & bm_ok, vv.gather(1, v_pos),
                        v_pos.to(dt), inp.hot.to(dt)[bm_i.clamp_max(N - 1)])
    v_val = fused_value(w, lw, torch.zeros_like(vec_ok), zero, ranks, vec_ok, vv, ranks,
                        inp.hot.to(dt)[vi.clamp_max(N - 1)])
    ids = torch.cat([torch.where(bm_ok, bm_i, N), torch.where(vec_ok & ~v_hit, vi, N)], dim=1)
    vals = torch.cat([torch.where(bm_ok, b_val, NEG), torch.where(vec_ok & ~v_hit, v_val, NEG)],
                     dim=1).double()
    bm_at = torch.cat([torch.where(bm_ok, bm_v, zero), zero], dim=1)
    vec_at = torch.cat([torch.where(b_hit & bm_ok, vv.gather(1, v_pos), -1.0),
                        torch.where(vec_ok, vv, -1.0)], dim=1)
    # value descending, doc ascending
    _, order = ids.sort(dim=1, stable=True)
    vals_s = vals.gather(1, order)
    top, pos = torch.sort(vals_s, dim=1, descending=True, stable=True)
    pos = pos[:, :K]
    take = order.gather(1, pos)
    return lw, (top[:, :K].float(), ids.gather(1, take), bm_at.gather(1, take).double(),
                vec_at.gather(1, take).double())


# -- the whole query, and the judge -----------------------------------------------
@dataclasses.dataclass
class Reference:
    vec: _Vectors
    vec_v: torch.Tensor     # (Q, depth) f64 descending
    vec_i: torch.Tensor
    lex: Lexical
    lw: LegWeights
    outputs: tuple          # the fused answers in the program's contract


def reference(inp: Inputs, sketch, tids, tmask, p: Params, precision: str = "config"):
    """The whole query over (Q, ...) queries, in blocks of QUERY_BLOCK."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        parts = [_reference(inp, sketch[lo:lo + QUERY_BLOCK], tids[lo:lo + QUERY_BLOCK],
                            tmask[lo:lo + QUERY_BLOCK], p, precision)
                 for lo in range(0, sketch.shape[0], QUERY_BLOCK)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return parts


def _reference(inp, sketch, tids, tmask, p: Params, precision: str) -> Reference:
    depth = p.C + DEPTH
    vec = _Vectors(inp, embed(sketch, inp.proj), precision)
    vv, vi = vector_top(inp, vec, depth)
    lex = lexical(inp, tids, tmask, p.take, depth, precision)
    dt = torch.float64 if precision == "config" else torch.bfloat16
    lw, out = fuse(inp, lex, vv, vi, p.C, p.K, dt)
    return Reference(vec, vv, vi, lex, lw, out)


def _ranks(top: torch.Tensor, x: torch.Tensor, eps: float):
    """Ranks (0-based, not clamped) that docs of values x (Q, n) can rightly
    take in a list of values `top` (Q, depth), descending, that holds each
    doc that ranks within it: before it for sure are the docs over x + eps,
    perhaps those down to x - eps. -> (best, worst)."""
    best = (top[:, None, :] > (x + eps)[:, :, None]).sum(dim=2)
    near = (top[:, None, :] >= (x - eps)[:, :, None]).sum(dim=2)
    return best, near - (x >= top[:, -1:]).long()


def judge(inp: Inputs, ref: Reference, answers, p: Params, eps_vec: float,
          eps_bm: float) -> dict[str, float]:
    """The four numbers for one block of queries. `answers` are (values,
    slots, lexical sums, vector scores), each (Q, K), as the program gives
    them; the two tolerances are how far apart two exact scores of a leg
    may lie and still be ordered either way by a right answer."""
    dev = inp.E.device
    f, s, bm, va = (torch.as_tensor(a).to(dev) for a in answers)
    f, bm, va = f.double(), bm.double(), va.double()
    N, C, w = inp.E.shape[0], p.C, inp.weights
    live = f > NEG / 2
    slot = s.long().clamp(0, N - 1)
    S = ref.vec.scores_at(slot) + _biases(inp, slot)
    B = ref.lex.at(slot)
    S_C = ref.vec_v[:, C - 1:C]
    B_C = ref.lex.top_v[:, C - 1:C]
    v_in = va > -1.0
    b_in = bm > 0

    def worst(x, m):
        return float(torch.where(m, x, 0.0).max().item()) if x.numel() else 0.0

    out = {
        "vec_gap": max(worst((va - S).abs(), live & v_in),
                       worst((S_C - S).clamp_min(0), live & v_in),
                       worst((S - S_C).clamp_min(0), live & ~v_in)),
        "bm25_gap": max(worst((bm - B).abs(), live & b_in),
                        worst((B_C - B).clamp_min(0), live & b_in),
                        worst((B - B_C).clamp_min(0), live & ~b_in)),
    }
    # each reported value against the interval of values its slot can take
    # in the legs it reports
    v_best, v_worst = _ranks(ref.vec_v, S, eps_vec)
    b_best, b_worst = _ranks(ref.lex.top_v, B, eps_bm)
    hot = inp.hot.double()[slot]

    def value(rb, rv):
        return fused_value(w, ref.lw, b_in, B, rb.clamp(0, C - 1).double(), v_in, S,
                           rv.clamp(0, C - 1).double(), hot)

    f_hi, f_lo = value(b_best, v_best), value(b_worst, v_worst)
    out["fused_gap"] = worst(torch.maximum(f_lo - f, f - f_hi).clamp_min(0), live)
    out["fused_miss"] = _fused_miss(inp, ref, f, s, live, C, eps_vec, eps_bm)
    return out


def _fused_miss(inp: Inputs, ref: Reference, f, s, live, C: int, eps_vec: float,
                eps_bm: float) -> float:
    """How far a doc that belongs in the fused top K even at its lowest
    right value lies above the lowest value reported, where it is not
    reported. A leg holds a doc for sure when its worst rank is within C,
    perhaps when its best is; the lowest right value is the least over the
    memberships it can have, at its worst ranks, and a doc that can be in
    neither leg's list need not be reported."""
    N, w = inp.E.shape[0], inp.weights
    vv, vi = ref.vec_v, ref.vec_i
    bv, bi = ref.lex.top_v, ref.lex.top_i
    in_vec = (bi[:, :, None] == vi[:, None, :]).any(dim=2)
    ids = torch.cat([vi, torch.where(in_vec, N, bi)], dim=1)      # every candidate once
    S = torch.cat([vv, torch.full_like(bv, -torch.inf)], dim=1)
    B = ref.lex.at(ids)
    v_best, v_worst = _ranks(vv, S, eps_vec)
    b_best, b_worst = _ranks(bv, B, eps_bm)
    v_can = (S > -1e29) & (v_best <= C - 1)
    v_sure = v_can & (v_worst <= C - 1)
    b_can = (B > 0) & (b_best <= C - 1)
    b_sure = b_can & (b_worst <= C - 1)
    hot = inp.hot.double()[ids.clamp_max(N - 1)]
    Sx = S.clamp_min(-1.0)

    def F(b, v):
        return fused_value(w, ref.lw, b, B, b_worst.clamp(0, C - 1).double(), v, Sx,
                           v_worst.clamp(0, C - 1).double(), hot)

    lo = torch.full_like(Sx, torch.inf)
    yes, no = torch.ones_like(v_can), torch.zeros_like(v_can)
    for b_opt, b_ok in ((yes, b_can), (no, ~b_sure)):
        for v_opt, v_ok in ((yes, v_can), (no, ~v_sure)):
            if b_opt is no and v_opt is no:
                continue
            lo = torch.minimum(lo, torch.where(b_ok & v_ok, F(b_opt, v_opt), torch.inf))
    lo = torch.where(v_sure | b_sure, lo, -torch.inf)
    f_last = torch.where(live, f, torch.inf).amin(dim=1, keepdim=True)
    f_last = torch.where(live.any(dim=1, keepdim=True), f_last, -1e30)
    reported = ((ids[:, :, None] == s.long()[:, None, :]) & live[:, None, :]).any(dim=2)
    gap = torch.where(~reported & (ids < N) & (v_sure | b_sure), lo - f_last, 0.0)
    return float(gap.clamp_min(0).max().item()) if gap.numel() else 0.0
