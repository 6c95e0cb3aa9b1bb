"""The port's span recorder (yams_tpu_torch.spans) and the spans and counters
inside the query program, on the CPU at a tiny size.

- Off, it records nothing, and `hybrid_query`'s answers are bit-identical
  with the recorder on and off, on the materialized and the streamed path.
- One call gives one tree: one request id, `hybrid_query` the root, one
  `block` a block with its `top_k`, then `merge`, `lexical_leg` and `fuse`;
  on the chunked path a `chunk_agg` span (rows, docs, agg) between the
  scores and the mask; an exception inside the call leaves no span open.
- `fusion.chunk_score_bytes`: a chunked call adds the (B, rows) f32 passes
  between the product and the selection (4 with "max"); a flat call none.
- `select.top_k`'s counters: `syncs` rises by blocks + 3 on a streamed call
  and by 3 on a materialized one, and the int8 query's quantization
  (`scan.quantize_rows`) adds one; `repair_rows` counts a tie straddling the
  cut, and nothing without one.
- The clock: mapped by its switch pairs, a span recorded around a
  `record_function` marker holds the marker in a CPU kineto trace, within
  1 ms; pairs a stepped clock split are refused.
- A traced `search_batch` gives one tree under one request id, and its
  `last_trace` keeps its keys.
"""

import threading

import numpy as np
import pytest
import torch

from yams_tpu_torch import spans
from yams_tpu_torch.core.config import (EmbeddingConfig, LexicalIndexConfig,
                                        VectorIndexConfig)
from yams_tpu_torch.ops.bm25 import pack_postings_2d
from yams_tpu_torch.ops.scan import quantize_rows
from yams_tpu_torch.ops.select import top_k
from yams_tpu_torch.search import fusion
from yams_tpu_torch.search.config import SearchEngineConfig
from yams_tpu_torch.search.engine import SearchEngine

ROWS, D, S, V, WIN, PER, B, T, C = 2048, 32, 64, 128, 32, 16, 4, 6, 8
BLOCK = 512
CHUNKS = 4                                   # rows a document on the chunked path
PATHS = {"materialized": {}, "streamed": {"scan_block_rows": BLOCK},
         "chunked": {"rows_are_docs": False}}
FLAT = ["materialized", "streamed"]


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and drained."""
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _args(int8: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    E = torch.randn(ROWS, D, generator=g)
    E = E / E.norm(dim=1, keepdim=True)
    E[9] = E[4]                                  # an exact vector-score tie
    if int8:
        scale = E.abs().amax(dim=1) / 127
        E = torch.round(E / scale[:, None]).to(torch.int8)
    else:
        scale, E = torch.ones(ROWS), E.to(torch.bfloat16)
    rng = np.random.default_rng(seed)
    pdoc = np.concatenate([rng.integers(0, ROWS, V * PER), np.full(WIN, ROWS)]).astype(np.int32)
    pimp = np.concatenate([np.sort(rng.gamma(2.0, 1.5, (V, PER)))[:, ::-1].ravel(),
                           np.zeros(WIN)]).astype(np.float32)
    offs = (np.arange(V) * PER).astype(np.int32)
    lens = np.full(V, PER, np.int32)
    packed, iscale = pack_postings_2d(pdoc, pimp, offs, lens, window=WIN, num_docs=ROWS)
    args = (torch.randn(B, S, generator=g),
            torch.randint(0, V, (B, T), generator=g, dtype=torch.int32),
            (torch.rand(B, T, generator=g) > 0.3).float(),
            (torch.randn(S, D, generator=g).sign() / D ** 0.5).to(torch.bfloat16),
            E, torch.ones(ROWS), torch.arange(ROWS, dtype=torch.int32), scale.float(),
            torch.from_numpy(packed), torch.tensor(iscale, dtype=torch.float32),
            torch.from_numpy(offs), torch.from_numpy(lens),
            torch.ones(ROWS, dtype=torch.uint8), torch.zeros(ROWS),
            torch.from_numpy(fusion.pack_weights(SearchEngineConfig())))
    kw = dict(k=C, rrf_cand=C, window=WIN, num_slots=ROWS, rows_are_docs=True,
              bm25_prefilter=PER, packed_lexical=True, int8_corpus=int8)
    return args, kw


def _query(path, int8=False, **extra):
    """One call on a path; on the chunked one CHUNKS rows a document."""
    args, kw = _args(int8)
    if path == "chunked":
        args = list(args)
        args[6] = torch.arange(ROWS, dtype=torch.int32) // CHUNKS
    return fusion.hybrid_query(*args, **{**kw, **PATHS[path], **extra})


def _counters():
    """(the program's syncs, top_k's rows and repaired rows)."""
    return top_k.syncs + quantize_rows.syncs, top_k.rows, top_k.repair_rows


def test_off_the_recorder_hands_out_one_null_context():
    assert spans.span("a", x=1) is spans.span("b") is spans.NULL
    assert spans.begin("c").end() >= 0.0        # a timed span times while off
    assert spans.drain() == ([], [])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("path", list(PATHS))
def test_off_it_records_nothing_and_on_the_answers_are_bit_identical(path, int8):
    off = _query(path, int8)
    assert spans.drain() == ([], [])
    spans.enable()
    on = _query(path, int8)
    spans.disable()
    records, clock = spans.drain()
    assert records and len(clock) == 2
    for a, b in zip(off, on, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _tree(records):
    names = [r[0] for r in records]
    children = {}
    for i, r in enumerate(records):
        children.setdefault(r[2], []).append(i)
    return names, children


@pytest.mark.parametrize("path", list(PATHS))
def test_one_call_gives_one_tree(path):
    spans.enable()
    _query(path)
    spans.disable()
    records, _ = spans.drain()
    names, children = _tree(records)
    assert {r[1] for r in records} == {records[0][1]}          # one request id
    assert children[-1] == [0] and names[0] == "hybrid_query"   # one root
    for name, request, parent, a, b, attrs in records:
        assert b is not None and a <= b
        if parent >= 0:                      # a child lies inside its parent
            assert records[parent][3] <= a and b <= records[parent][4]
    assert [names[j] for j in children[0]] == ["embed", "vector_leg", "lexical_leg", "fuse"]
    vector_leg = names.index("vector_leg")
    blocks = [j for j in children[vector_leg] if names[j] == "block"]
    if path == "chunked":
        assert [names[j] for j in children[vector_leg]] == ["scores", "chunk_agg", "mask_bias",
                                                             "top_k"]
        agg = records[names.index("chunk_agg")][5]
        assert agg == {"rows": ROWS, "docs": ROWS, "agg": "max"}
    elif path == "streamed":
        assert len(blocks) == ROWS // BLOCK
        assert [records[j][5]["lo"] for j in blocks] == list(range(0, ROWS, BLOCK))
        for j in blocks:
            assert [names[c] for c in children[j]] == ["scores", "mask_bias", "top_k"]
        assert [names[j] for j in children[vector_leg]][-1] == "merge"
        assert [names[j] for j in children[names.index("merge")]] == ["top_k"]
    else:
        assert not blocks and "merge" not in names
        assert [names[j] for j in children[vector_leg]] == ["scores", "mask_bias", "top_k"]
    assert "top_k" in [names[j] for j in children[names.index("lexical_leg")]]
    assert "top_k" in [names[j] for j in children[names.index("fuse")]]
    top = [r for r in records if r[0] == "top_k"]
    assert all(set(r[5]) == {"rows", "cols", "k"} for r in top)


def test_an_exception_inside_the_call_leaves_no_span_open():
    args, kw = _args(False)
    args = list(args)
    args[1] = args[1] + V                   # term ids past the vocabulary
    spans.enable()
    with pytest.raises(IndexError):
        fusion.hybrid_query(*args, **kw)
    assert getattr(spans._local, "stack", []) == []
    _query("materialized")                  # the next call is a tree of its own
    spans.disable()
    records, _ = spans.drain()
    assert all(r[4] is not None for r in records)
    roots = [r for r in records if r[2] == -1]
    assert [r[0] for r in roots] == ["hybrid_query", "hybrid_query"]
    assert roots[0][1] != roots[1][1]


def test_a_timed_span_left_open_ends_with_the_span_around_it():
    spans.enable()
    with spans.begin("root"):
        with spans.span("outer"):
            inner = spans.begin("inner")         # never ended inside `outer`
        left = spans.begin("left")               # never ended at all
    ms = inner.end()
    spans.disable()
    records, _ = spans.drain()
    by = {r[0]: r for r in records}
    assert by["inner"][4] == by["outer"][4] and ms == pytest.approx(
        (by["inner"][4] - by["inner"][3]) * 1e-6)
    assert by["left"][4] == by["root"][4] and left.end_ns is None
    assert [by[n][2] for n in ("outer", "inner", "left")] == [0, 1, 0]
    assert getattr(spans._local, "stack", []) == []


@pytest.mark.parametrize("path", list(PATHS))
def test_syncs_rise_by_blocks_plus_three(path):
    s0, r0, _ = _counters()
    calls = fusion.hybrid_query_calls
    _query(path)
    s1, r1, _ = _counters()
    blocks = ROWS // BLOCK if path == "streamed" else 0
    assert s1 - s0 == blocks + 3
    assert fusion.hybrid_query_calls == calls + 1
    # B rows a selection: each block's (or the one vector top-C), the merge,
    # the lexical leg's, the fusion's
    assert r1 - r0 == B * (blocks + 3)


@pytest.mark.parametrize("path", list(PATHS))
def test_the_int8_query_quantization_syncs_once_more(path):
    """Its divisor's copy to the device waits for the queue on a card."""
    s0, _, _ = _counters()
    q0 = quantize_rows.syncs
    _query(path, int8=True)
    s1, _, _ = _counters()
    blocks = ROWS // BLOCK if path == "streamed" else 0
    assert s1 - s0 == blocks + 4 and quantize_rows.syncs == q0 + 1


@pytest.mark.parametrize("agg, passes", [("max", 4), ("sum", 6), ("topk_avg", 10),
                                         ("weighted_topk_avg", 10)])
def test_a_chunked_call_counts_its_chunk_score_passes(agg, passes):
    """The product's write, the validity bias's read and write, and the
    aggregation's passes over the (B, rows) f32 chunk scores."""
    n0 = fusion.chunk_score_bytes
    _query("chunked", chunk_agg=agg)
    assert fusion.chunk_score_bytes - n0 == passes * B * ROWS * 4


@pytest.mark.parametrize("path", FLAT)
def test_a_flat_call_counts_no_chunk_scores(path):
    n0 = fusion.chunk_score_bytes
    _query(path)
    assert fusion.chunk_score_bytes == n0


def test_repair_rows_count_a_tie_straddling_the_cut():
    x = torch.tensor([[5.0, 4.0, 3.0, 2.0, 1.0], [9.0, 8.0, 7.0, 6.0, 5.0]])
    _, _, p0 = _counters()
    spans.enable()
    top_k(x, 2)
    assert _counters()[2] == p0
    x[1, 3] = 8.0                            # 8 twice, one kept at k = 2
    vals, pos = top_k(x, 2)
    spans.disable()
    assert _counters()[2] == p0 + 1
    assert pos.tolist() == [[0, 1], [0, 1]] and vals[1].tolist() == [9.0, 8.0]
    records, _ = spans.drain()
    assert [r[0] for r in records] == ["top_k", "top_k", "tie_repair"]
    assert records[2][2] == 1 and records[2][5] == {"rows": 1}


def test_threads_keep_their_own_trees():
    spans.enable()

    def work():
        with spans.span("outer"):
            with spans.span("inner"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans.disable()
    records, _ = spans.drain()
    outer = {i: r[1] for i, r in enumerate(records) if r[0] == "outer"}
    assert len(outer) == 4 and len(set(outer.values())) == 4
    for r in records:
        if r[0] == "inner":
            assert r[2] in outer and outer[r[2]] == r[1]


def test_mapped_by_its_clock_a_span_holds_the_profilers_marker():
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.enable()
        with spans.span("outer"):
            with record_function("marker"):
                for _ in range(20):
                    x = (x @ x).tanh()
        spans.disable()
    records, clock = spans.drain()
    off = spans.wall_offset_ns(clock)
    (_, _, _, a, b, _), = records
    marks = [e for e in prof.profiler.kineto_results.events() if e.name() == "marker"]
    assert len(marks) == 1
    m0 = marks[0].start_ns()
    m1 = m0 + marks[0].duration_ns()
    ms = 1_000_000
    assert a + off <= m0 + ms and m1 <= b + off + ms
    assert m0 - (a + off) < 50 * ms and (b + off) - m1 < 50 * ms


def test_a_stepped_wall_clock_is_refused():
    assert spans.wall_offset_ns([(100, 1100), (200, 1200)]) == 1000
    with pytest.raises(ValueError):
        spans.wall_offset_ns([(100, 1100), (200, 1200 + 2 * spans.MAX_CLOCK_DRIFT_NS)])
    with pytest.raises(ValueError):
        spans.wall_offset_ns([])


def test_a_traced_search_batch_gives_one_tree_under_one_request():
    eng = SearchEngine(config=SearchEngineConfig(batch_pad=4),
                       embedding=EmbeddingConfig(dim=64, sketch_dim=512),
                       vector=VectorIndexConfig(dim=64, capacity=256, block_rows=128),
                       lexical=LexicalIndexConfig(postings_window=64), device="cpu")
    for i in range(24):
        eng.add_document(i, f"document {i} about topic{i % 5} and words here")
    eng.search_batch(["topic1 words", "document 3"], k=5)
    untraced = eng.last_trace
    spans.enable()
    eng.search_batch(["topic1 words", "document 3"], k=5)
    spans.disable()
    records, _ = spans.drain()
    assert {r[1] for r in records} == {records[0][1]}
    assert records[0][0] == "search_batch" and records[0][2] == -1
    assert sum(r[2] == -1 for r in records) == 1
    names, children = _tree(records)
    root_kids = [names[j] for j in children[0]]
    assert root_kids[0] == "host_prep" and "device" in root_kids
    device = names.index("device")
    assert "hybrid_query" in [names[j] for j in children[device]]
    assert set(eng.last_trace) == set(untraced)
    assert set(eng.last_trace["stages"]) == set(untraced["stages"])
    stages = eng.last_trace["stages"]
    by_name = {r[0]: (r[4] - r[3]) * 1e-6 for r in records}
    assert stages["host_prep_ms"] == pytest.approx(by_name["host_prep"])
    assert stages["device_ms"] == pytest.approx(by_name["device"])
    assert eng.last_trace["total_ms"] == pytest.approx(by_name["search_batch"])
