"""The chunked path's segment max: `ops/segment.py` and `csrc/segment_max.cu`.

On the CPU: `segment_max_plain` against a per-slot maximum written out on
adversarial layouts; the launcher's refusals; `_aggregate_chunks` on a CPU
tensor, which keeps `scatter_reduce_` and never launches the kernel.

On a card (marked `card`, skipped without one), run there with

    python -m pytest tests/test_torch_segment.py -m card --noconftest -q

(`--noconftest`: the suite's conftest imports JAX, which the card's machine
does not have): the kernel bit for bit against `segment_max_plain` and
against `scatter_reduce_` amax on the floats, which agree but where a slot's
maximum is a zero of both signs (`scatter_reduce_` keeps the zero it met
last); `_aggregate_chunks` on the card against the CPU's `scatter_reduce_`
path; one chunked `hybrid_query`, card against CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yams_tpu_torch.ops.segment import segment_max_cuda, segment_max_plain
from yams_tpu_torch.search import fusion

TILE = 4096          # rows a CTA of the kernel owns (csrc/segment_max.cu kTile)
LAYOUTS = ("runs", "permuted", "tombstones", "one_slot", "alternating", "out_of_range")
VALUES = ("normal", "specials")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/segment_max.cu runs only there")
    return torch.device("cuda", 0)


def layout(kind: str, rows: int, m: int, seed: int) -> np.ndarray:
    """(rows,) int32 row2slot for m slots. `runs`: runs of 1 to 5,000 rows
    (lengths at and around the kernel's 128-row step and 4,096-row tile among
    them) at increasing slots, some slots left without rows; `permuted` its
    rows shuffled; `tombstones` -1 stretches at the start, the middle and the
    end and single -1 rows; `one_slot` every row at one slot; `alternating`
    two slots row by row; `out_of_range` slots at and past m among the runs."""
    g = np.random.default_rng(seed)
    if kind == "one_slot":
        return np.full(rows, m // 2, np.int32)
    if kind == "alternating":
        return (np.arange(rows) % 2 + 3).astype(np.int32)
    edges = np.array([1, 2, 3, 4, 5, 127, 128, 129, 1000, TILE - 1, TILE, TILE + 1, 5000])
    lengths, total = [], 0
    while total < rows:
        n = int(g.choice(edges)) if g.random() < 0.5 else int(g.integers(1, 40))
        lengths.append(n)
        total += n
    slots = np.cumsum(g.integers(1, 3, len(lengths))) % m     # some slots get no row
    r2s = np.repeat(slots, lengths)[:rows].astype(np.int32)
    if kind == "permuted":
        r2s = r2s[g.permutation(rows)]
    elif kind == "tombstones":
        r2s[:37] = -1
        r2s[rows // 2 - 300:rows // 2 + 400] = -1
        r2s[-129:] = -1
        r2s[g.random(rows) < 0.02] = -1
    elif kind == "out_of_range":
        r2s[g.random(rows) < 0.05] = m
        r2s[g.random(rows) < 0.01] = np.iinfo(np.int32).max
    return r2s


def scores(kind: str, B: int, rows: int, seed: int, signed_zero: bool = True) -> torch.Tensor:
    """(B, rows) f32: Gaussian, or ties among +-0.0, +-inf, -1e30 and a few
    plain values (-0.0 left out where `signed_zero` is False)."""
    g = np.random.default_rng(seed)
    if kind == "normal":
        x = g.standard_normal((B, rows))
    else:
        pool = [0.0, np.inf, -np.inf, -1e30, 1.0, -1.0, 2.5] + ([-0.0] if signed_zero else [])
        x = g.choice(np.array(pool), (B, rows))
    return torch.from_numpy(x.astype(np.float32))


def start(B: int, m: int, seed: int) -> torch.Tensor:
    """(B, m) f32 to update: -inf, and 0.5 in a tenth of the slots."""
    g = np.random.default_rng(seed)
    return torch.from_numpy(np.where(g.random((B, m)) < 0.1, 0.5, -np.inf).astype(np.float32))


def ieee_segment_max(x: np.ndarray, r2s: np.ndarray, out: np.ndarray) -> np.ndarray:
    """The function by its definition, slot by slot: the largest value,
    -0 below +0."""
    out = out.copy()
    m = out.shape[1]
    for s in np.unique(r2s[(r2s >= 0) & (r2s < m)]):
        vals = np.concatenate([x[:, r2s == s], out[:, s:s + 1]], axis=1)
        top = vals.max(axis=1)
        plus_zero = ((vals == 0) & ~np.signbit(vals)).any(axis=1)
        out[:, s] = np.where(top == 0, np.where(plus_zero, 0.0, -0.0), top)
    return out


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("kind", LAYOUTS)
def test_segment_max_plain_is_the_ieee_maximum(kind, values):
    rows, m, B = 3 * TILE + 1235, 700, 3
    r2s = layout(kind, rows, m, seed=rows)
    x = scores(values, B, rows, seed=B)
    out = start(B, m, seed=m)
    want = ieee_segment_max(x.numpy(), r2s, out.numpy())
    got = segment_max_plain(x, torch.from_numpy(r2s), out)
    assert torch.equal(bits(got), bits(torch.from_numpy(want)))


_X, _R, _O = torch.zeros(4, 100), torch.zeros(100, dtype=torch.int32), torch.zeros(4, 9)


@pytest.mark.parametrize("x,r2s,out,refusal", [
    (_X, _R, _O, "CUDA"),                                   # CPU tensors
    (_X.double(), _R, _O, "f32"),
    (_X.bfloat16(), _R, _O, "f32"),
    (_X, _R.long(), _O, "int32"),
    (_X, _R, _O.half(), "f32"),
    (_X[None], _R, _O, r"\(B, rows\)"),
    (_X, _R[:99], _O, r"\(B, rows\)"),
    (_X, _R, _O[:3], r"\(B, rows\)"),
    (_X, _R, _O[0], r"\(B, rows\)"),
    (torch.zeros(100, 4).t(), _R, _O, "contiguous"),
    (_X, torch.zeros(200, dtype=torch.int32)[::2], _O, "contiguous"),
    (_X, _R, torch.zeros(4, 18)[:, ::2], "contiguous"),
])
def test_segment_max_cuda_refuses(x, r2s, out, refusal):
    launches = segment_max_cuda.launches
    with pytest.raises(ValueError, match=refusal):
        segment_max_cuda(x, r2s, out)
    assert segment_max_cuda.launches == launches


@pytest.mark.parametrize("chunk_agg,scatters", [
    ("max", 1), ("sum", 1), ("topk_avg", 2), ("weighted_topk_avg", 2)])
def test_cpu_aggregation_keeps_scatter_reduce(monkeypatch, chunk_agg, scatters):
    """On a CPU tensor every segment reduction is `scatter_reduce_` into the
    sink layout, and the kernel's counter does not move; "max" equals the
    plain segment max of the live rows."""
    rows, num_slots, B = 2 * TILE + 77, 300, 5
    r2s = torch.from_numpy(layout("tombstones", rows, num_slots, seed=1))
    x = scores("normal", B, rows, seed=2)
    calls = []
    scatter = torch.Tensor.scatter_reduce_

    def spy(self, *args, **kwargs):
        calls.append(kwargs.get("reduce"))
        return scatter(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "scatter_reduce_", spy)
    launches = segment_max_cuda.launches
    got = fusion._aggregate_chunks(x.clone(), r2s, num_slots, chunk_agg)
    assert len(calls) == scatters and segment_max_cuda.launches == launches
    assert got.shape == (B, num_slots)
    if chunk_agg == "max":
        want = segment_max_plain(x, r2s, torch.full((B, num_slots), -torch.inf))
        assert torch.equal(bits(got), bits(want))


# -- on a card ----------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("rows", [3 * TILE + 1235, 4 * TILE + 1236, 333])
@pytest.mark.parametrize("B", [1, 63, 1024])
@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("kind", LAYOUTS)
def test_segment_max_cuda_on_card(card, kind, values, B, rows):
    """Bit for bit against the plain version everywhere and against
    `scatter_reduce_` amax on the floats wherever a slot's maximum is not a
    zero of both signs (there equal as values). Row counts are no multiple
    of the tile; 3 x 4,096 + 1,235 and 333 are no multiple of 4 either
    (scalar loads), 4 x 4,096 + 1,236 is (16-byte loads)."""
    m = 701
    r2s = torch.from_numpy(layout(kind, rows, m, seed=rows + B)).to(card)
    x = scores(values, B, rows, seed=B).to(card)
    out = start(B, m, seed=m).to(card)
    launches = segment_max_cuda.launches
    got = segment_max_cuda(x, r2s, out.clone())
    torch.cuda.synchronize()
    assert segment_max_cuda.launches == launches + 1
    assert torch.equal(bits(got), bits(segment_max_plain(x, r2s, out.clone())))
    live = (r2s >= 0) & (r2s < m)
    seg = torch.where(live, r2s.long(), m)
    wide = torch.cat([out, out.new_full((B, 1), -torch.inf)], dim=1)
    flt = wide.scatter_reduce_(1, seg[None].expand(B, -1), x, reduce="amax",
                               include_self=True)[:, :m]
    same = bits(got) == bits(flt)
    assert torch.equal(same | ((got == 0) & (flt == 0)), torch.ones_like(same))
    if values == "normal":
        assert bool(same.all())


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 63, 1024])
@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("kind", ["runs", "permuted", "tombstones", "alternating"])
@pytest.mark.parametrize("chunk_agg", ["max", "topk_avg", "weighted_topk_avg"])
def test_aggregate_chunks_on_card(card, chunk_agg, kind, values, B):
    """The card's aggregation (the kernel for each segment max) against the
    CPU's `scatter_reduce_` path, bit for bit. No -0.0 among the scores: the
    CPU's `scatter_reduce_` keeps the first of equal zeros, and the
    chunked path's scores carry none (the validity bias adds +0.0)."""
    rows, num_slots = 3 * TILE + 1235, 701
    r2s = torch.from_numpy(layout(kind, rows, num_slots, seed=rows))
    x = scores(values, B, rows, seed=B, signed_zero=False)
    launches = segment_max_cuda.launches
    got = fusion._aggregate_chunks(x.to(card), r2s.to(card), num_slots, chunk_agg).cpu()
    assert segment_max_cuda.launches == launches + (1 if chunk_agg == "max" else 2)
    want = fusion._aggregate_chunks(x.clone(), r2s, num_slots, chunk_agg)
    assert torch.equal(bits(got), bits(want))


def chunked_inputs(seed: int, rows: int = 20_000, docs: int = 1_500, B: int = 16,
                   D: int = 64, S: int = 96, V: int = 200, W: int = 64, T: int = 6):
    """A small chunked store as `search_batch` hands it over: a document's
    rows contiguous, tombstones at -1 (invalid), a CSR lexical leg."""
    g = np.random.default_rng(seed)
    weights = np.exp(g.standard_normal(docs))
    counts = 1 + g.multinomial(rows - docs - 500, weights / weights.sum())
    r2s = np.full(rows, -1, np.int32)
    r2s[:counts.sum()] = np.repeat(np.arange(docs, dtype=np.int32), counts)
    r2s[g.random(rows) < 0.02] = -1
    E = g.standard_normal((rows, D)).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    lens = g.integers(0, W + 1, V).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    P = int(lens.sum())
    pimp = np.zeros(P + W, np.float32)
    for o, n in zip(offs, lens):
        pimp[o:o + n] = np.sort(g.gamma(2.0, 1.5, n))[::-1]
    from yams_tpu_torch.search.config import SearchEngineConfig

    arrays = dict(
        sketch=g.standard_normal((B, S)).astype(np.float32),
        tids=g.integers(0, V, (B, T)).astype(np.int32),
        tmask=g.choice([0.0, 0.6, 1.0], (B, T)).astype(np.float32),
        proj=(np.sign(g.standard_normal((S, D))) / np.sqrt(D)).astype(np.float32),
        E=E, valid=(r2s >= 0).astype(np.float32), r2s=r2s, scale=np.ones(rows, np.float32),
        pdoc=np.concatenate([g.integers(0, docs, P), np.full(W, docs)]).astype(np.int32),
        pimp=pimp, offs=offs, lens=lens,
        doc_mask=(g.random(docs) > 0.1).astype(np.float32),
        hot=np.zeros(docs, np.float32),
        w=fusion.pack_weights(SearchEngineConfig()))
    tensors = [torch.from_numpy(a) for a in arrays.values()]
    tensors[3], tensors[4] = tensors[3].bfloat16(), tensors[4].bfloat16()
    return tensors, dict(k=20, rrf_cand=16, window=W, num_slots=docs)


@pytest.mark.card
@pytest.mark.parametrize("chunk_agg", ["max", "topk_avg", "weighted_topk_avg"])
def test_chunked_hybrid_query_card_against_cpu(card, chunk_agg):
    """One chunked `hybrid_query` on the card and on the CPU: the card's
    vector scores are f32 sums of bf16 products in another order, so the
    fused values agree to 1e-5 and a slot may differ only where its fused
    value is within 1e-5 of the CPU's value for that slot, or of the CPU's
    last value where the slot left the CPU's list (near-ties)."""
    args, kw = chunked_inputs(seed=11)
    launches = segment_max_cuda.launches
    got = [a.cpu() for a in fusion.hybrid_query(*[a.to(card) for a in args], **kw,
                                                chunk_agg=chunk_agg)]
    assert segment_max_cuda.launches > launches
    want = fusion.hybrid_query(*args, **kw, chunk_agg=chunk_agg)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    for q, j in zip(*torch.nonzero(got[1] != want[1], as_tuple=True)):
        slot, value = got[1][q, j], got[0][q, j]
        on_cpu = want[0][q][want[1][q] == slot]
        near = on_cpu.numel() == 1 and abs(float(on_cpu[0] - value)) <= 1e-5
        assert near or abs(float(want[0][q, -1] - value)) <= 1e-5, (int(q), int(j))
