"""The inputs of the hybrid-search cells, made on the device from the seed.

Every function here is the benchmark's own: the program under test and the
reference receive what these make and nothing else.

Sources, each copied and then cut only as said:
- `clustered_rows`, `clustered_bf16`, `clustered_int8`: `chip_smoke.py`
  `clustered_corpus` and `clustered_int8` (themselves bench.py's corpus:
  4,096 unit centres, bf16 Gaussian noise of sigma 0.35, rows L2-normalized,
  row r in centre ((r * 2654435761) mod 2**32 >> 7) mod 4,096). Here both
  dtypes are made a block of rows at a time, so the noise of a block is its
  own draw, and the int8 rows are quantized by `quantize_int8_rows` below, a
  copy of the stored int8 index's arithmetic (`yams_tpu_torch/ops/scan.py`
  `quantize_int8` and `quantize_rows`).
- `packed_qbits`: `yams_tpu_torch/ops/bm25.py` `packed_qbits`, the packed
  postings' key layout (doc id in the high bits, impact in the low).
- `packed_postings`: `chip_smoke.py` `packed_postings` (bench.py's postings:
  term t's posting c names doc ((t * per_term + c) * 2654435761 mod 2**32)
  mod N, impact 0.5 + 4.75 (1 + c)**-0.7 quantized to the key's low bits,
  the window's second half sink-padded), with the sizes taken as arguments.
- `sign_projection` and the Gaussian sketches of `query_pool`: chip_smoke's
  phase 4 (bench.py's +-1/sqrt(D) bf16 projection and N(0, 1) sketches).
- The term lists of `query_pool` are new: lengths from a fixed histogram,
  ids Zipf-skewed, distinct within a query, padded with id 0 at weight 0 as
  `LexicalIndex.query_term_ids` pads them.
"""

from __future__ import annotations

import math

import torch

HASH = 2654435761


def _hash_mod(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x * HASH) & 0xFFFFFFFF) % n


def unit_centers(gen: torch.Generator, device, n_centers: int, D: int) -> torch.Tensor:
    c = torch.randn(n_centers, D, generator=gen, device=device)
    return c / c.norm(dim=1, keepdim=True).clamp_min(1e-9)


def clustered_rows(gen: torch.Generator, centers: torch.Tensor, lo: int, hi: int,
                   sigma: float) -> torch.Tensor:
    """Rows lo..hi of the clustered corpus, (hi - lo, D) bf16, unit norm."""
    dev = centers.device
    ar = torch.arange(lo, hi, device=dev, dtype=torch.int64)
    assign = (((ar * HASH) & 0xFFFFFFFF) >> 7) % centers.shape[0]
    noise = torch.randn(hi - lo, centers.shape[1], generator=gen, device=dev,
                        dtype=torch.bfloat16)
    e = (centers[assign].to(torch.bfloat16) + sigma * noise).float()
    del noise
    return (e / e.norm(dim=1, keepdim=True).clamp_min(1e-9)).to(torch.bfloat16)


def clustered_bf16(gen: torch.Generator, device, N: int, D: int, n_centers: int,
                   sigma: float, block: int) -> torch.Tensor:
    centers = unit_centers(gen, device, n_centers, D)
    E = torch.empty(N, D, dtype=torch.bfloat16, device=device)
    for lo in range(0, N, block):
        hi = min(N, lo + block)
        E[lo:hi] = clustered_rows(gen, centers, lo, hi, sigma)
    return E


def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: (N, D) f32 -> (int8 codes, f32 scales), the
    stored int8 index's arithmetic (absmax / 127, round half to even, clip
    to +-127). The divisor is a device tensor: on a card a division by a
    Python number becomes a multiply by its reciprocal."""
    amax = x.abs().amax(dim=1).clamp_min(1e-12)
    scale = amax / amax.new_tensor(127.0)
    q = torch.round(x / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def clustered_int8(gen: torch.Generator, device, N: int, D: int, n_centers: int,
                   sigma: float, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The clustered corpus as a stored int8 index holds it: (N, D) int8
    codes and (N,) f32 row scales, a block at a time (no bf16 copy of the
    whole corpus)."""
    centers = unit_centers(gen, device, n_centers, D)
    E8 = torch.empty(N, D, dtype=torch.int8, device=device)
    scale = torch.empty(N, dtype=torch.float32, device=device)
    for lo in range(0, N, block):
        hi = min(N, lo + block)
        E8[lo:hi], scale[lo:hi] = quantize_int8_rows(
            clustered_rows(gen, centers, lo, hi, sigma).float())
    return E8, scale


def packed_qbits(num_docs: int) -> int:
    """Low bits left for the quantized impact when doc ids up to num_docs
    (the sink) fill the high bits of a signed int32 key."""
    id_bits = int(math.ceil(math.log2(num_docs + 2)))
    return max(31 - id_bits, 1)


def impacts(positions: torch.Tensor, lex: dict) -> torch.Tensor:
    """The zipf impact of each posting position (f32)."""
    return lex["impact_base"] + lex["impact_scale"] * (1.0 + positions.float()) ** -lex["impact_exponent"]


def packed_postings(device, N: int, lex: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(V, window) int32 keys `doc << qbits | quantized impact`, sink-padded
    past `postings_per_term`, and the impact scale (a 0-dim f32 tensor)."""
    V, WIN, per_term = lex["terms"], lex["postings_window"], lex["postings_per_term"]
    vmax = float(lex["impact_max"])
    qbits = packed_qbits(N)
    qmax = (1 << qbits) - 1
    tt = torch.arange(V, device=device, dtype=torch.int64)[:, None]
    cc = torch.arange(WIN, device=device, dtype=torch.int64)[None, :]
    docs = _hash_mod(tt * per_term + cc, N)
    q = torch.clamp(torch.round(impacts(cc, lex) * (qmax / vmax)), 0, qmax).long()
    packed = torch.where(cc < per_term, (docs << qbits) | q, N << qbits).to(torch.int32)
    return packed, torch.tensor(vmax, dtype=torch.float32, device=device)


def sign_projection(gen: torch.Generator, device, S: int, D: int) -> torch.Tensor:
    """(S, D) bf16 +-1/sqrt(D) sketch projection."""
    p = torch.where(torch.rand(S, D, generator=gen, device=device) < 0.5, 1.0, -1.0)
    return (p / math.sqrt(D)).to(torch.bfloat16)


def length_counts(n: int, weights: list[float]) -> list[int]:
    """n split over the lengths 1..len(weights) in proportion to `weights`,
    by largest remainder: the same counts for every seed."""
    total = float(sum(weights))
    exact = [n * w / total for w in weights]
    counts = [int(math.floor(x)) for x in exact]
    order = sorted(range(len(weights)), key=lambda i: (counts[i] - exact[i], i))
    for i in order[: n - sum(counts)]:
        counts[i] += 1
    return counts


def query_pool(gen: torch.Generator, device, n_queries: int, S: int, V: int,
               query: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n_queries (sketch (S,) f32, term ids (T,) i32, term weights (T,) f32).

    Lengths: `length_counts` of the mix's histogram, in an order drawn from
    the seed. Ids: `draws` Zipf(s) draws over V terms (rank r has weight
    (r + 1)**-s), the first `length` distinct ones kept in draw order; a
    query whose draws hold fewer distinct ids keeps them all. Pads: id 0,
    weight 0."""
    T, draws = query["max_terms"], query["draws"]
    weights = query["term_count_weights"]
    if len(weights) != T:
        raise ValueError(f"term_count_weights has {len(weights)} entries for max_terms {T}")
    sketches = torch.randn(n_queries, S, generator=gen, device=device)
    lengths = torch.cat([torch.full((c,), i + 1, dtype=torch.int64)
                         for i, c in enumerate(length_counts(n_queries, weights))]).to(device)
    lengths = lengths[torch.randperm(n_queries, generator=gen, device=device)]
    ranks = torch.arange(V, device=device, dtype=torch.float64)
    cdf = torch.cumsum((ranks + 1.0) ** -float(query["zipf_s"]), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n_queries, draws, generator=gen, device=device, dtype=torch.float64)
    ids = torch.searchsorted(cdf, u).clamp_max_(V - 1)
    earlier = torch.tril(torch.ones(draws, draws, dtype=torch.bool, device=device), -1)
    dup = ((ids[:, :, None] == ids[:, None, :]) & earlier).any(dim=2)
    rank = torch.cumsum(~dup, dim=1)
    keep = ~dup & (rank <= lengths[:, None])
    tids = torch.zeros(n_queries, T, dtype=torch.int32, device=device)
    tmask = torch.zeros(n_queries, T, dtype=torch.float32, device=device)
    row = torch.arange(n_queries, device=device)[:, None].expand_as(ids)
    tids[row[keep], rank[keep] - 1] = ids[keep].to(torch.int32)
    tmask[row[keep], rank[keep] - 1] = 1.0
    return sketches, tids, tmask
