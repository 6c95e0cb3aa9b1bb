"""The chunked-store cell at a size a CPU test holds: the port's chunked path
agrees with the plain reference and the control does not; a program that
takes a document's first segment, loses a segment or reads rows as
documents is judged wrong; the least time counts valid segments alone; and
the system hands `hybrid_query` what `SearchEngine.search_batch` hands it
for a store of several chunks a document."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import control, spec
from portbench.reference import hybrid as ref
from portbench.systems import chunked

CELL = "chunks7m-bf16.bulk"


def tiny() -> spec.CellSpec:
    """The cell cut to 7,000 segments (676 documents, 16,384 rows, 1,024
    slots) of 64 dims, and what its mix reads cut as `tiny.py` cuts it."""
    c = spec.cell(CELL)
    cfg = copy.deepcopy(c.config)
    cfg.update(rows=7000, dim=64, sketch_dim=256)
    cfg["corpus"].update(block_rows=2048, centers=64)
    cfg["lexical"].update(terms=512, postings_window=64, postings_per_term=32)
    mix = copy.deepcopy(c.mix)
    mix.update(batch=8, pool_batches=4, sample_requests=3)
    mix["search"].update(rrf_cand=16, device_k=16, bm25_prefilter=16)
    return spec.CellSpec(c.name, 1, cfg, mix, c.limits, c.tie_eps, c.end_to_end, c.per_layer)


def _failed(c: spec.CellSpec, numbers: dict) -> list[str]:
    return [n for n, lim in c.limits.items() if numbers[n] > lim["limit"]]


def test_the_files_shapes_are_the_ones_the_system_works_out():
    cfg = spec.cell(CELL).config
    docs, cap, num_slots = chunked.shapes(cfg)
    assert (docs, cap, num_slots) == (cfg["docs"], cfg["capacity"], cfg["num_slots"])
    assert (docs, cap, num_slots) == (685_035, 8_388_608, 1_048_576)
    pub = cfg["published"]
    assert cfg["rows"] == round(pub["segments"] / cfg["shards"])
    assert docs == round(pub["docs"] / cfg["shards"])
    assert cfg["chunk_agg"] == "max" and cfg["reduced"] == ["rows", "docs"]


def test_segment_counts_hold_every_row_and_a_segment_a_document():
    gen = torch.Generator().manual_seed(2**33 + 5)
    counts = chunked.segment_counts(gen, "cpu", 5000, 51_800, 1.0)
    assert counts.shape == (5000,) and int(counts.sum()) == 51_800 and int(counts.min()) >= 1
    assert int(counts.max()) > 4 * 51_800 // 5000          # the log-normal tail


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
def test_the_port_agrees_with_the_reference_and_the_control_does_not(seed):
    c = tiny()
    r = control.readings(c, seed, True, "cpu")
    assert r["queries"] == c.mix["batch"] * c.mix["sample_requests"]
    assert _failed(c, r["program"]) == [], r["program"]
    assert {"vec_gap", "fused_gap"} <= set(_failed(c, r["control"])), r["control"]


def _first_segment(srow, row2slot, num_slots, chunk_agg):
    """Each document's first segment's score in place of its best."""
    seg = torch.where(row2slot < 0, num_slots, row2slot).long()
    rows = torch.arange(seg.shape[0], device=seg.device)
    first = torch.full((num_slots + 1,), seg.shape[0], dtype=torch.long, device=seg.device)
    first.scatter_reduce_(0, seg, rows, reduce="amin")
    out = torch.full((srow.shape[0], num_slots), -torch.inf, device=srow.device)
    has = first[:num_slots] < seg.shape[0]
    out[:, has] = srow[:, first[:num_slots][has]]
    return out


def _drop_best_segment(sut, i):
    """The program's row2slot with the best segment of one reported vector
    document (of several segments: the first answered query's best) sent to
    the sink, as a lost row."""
    _, slots, _, vec_at = (torch.as_tensor(a) for a in sut.request(i))
    counts = torch.bincount(sut._row2slot[sut._row2slot >= 0].long())
    ok = (vec_at > -1) & (counts[slots.long()] > 1)
    qi = int(torch.nonzero(ok.any(dim=1))[0])
    doc = int(slots[qi][torch.argmax(torch.where(ok[qi], vec_at[qi], -2.0))])
    q = ref.embed(sut.sketches[sut._rows(i)][qi:qi + 1], sut.inputs.proj)
    rows = torch.nonzero(sut._row2slot == doc).flatten()
    best = rows[torch.argmax(sut.inputs.E[rows].double() @ q[0].to(torch.bfloat16).double())]
    row2slot = sut._row2slot.clone()
    row2slot[best] = -1
    return row2slot


@pytest.mark.parametrize("fault", ["first_segment", "dropped_segment", "rows_are_docs"])
def test_a_broken_aggregation_is_judged_wrong(fault, monkeypatch):
    from yams_tpu_torch.search import fusion

    c = tiny()
    sut = chunked.Cell(c.config, c.mix, 11, "cpu")
    i = 1
    if fault == "first_segment":
        monkeypatch.setattr(fusion, "_aggregate_chunks", _first_segment)
    elif fault == "dropped_segment":
        sut._row2slot = _drop_best_segment(sut, i)
    else:
        sut.kw["rows_are_docs"] = True
    answers = {i: sut.request(i)}
    numbers, _ = sut.judge(answers, [i], c.tie_eps)
    assert _failed(c, numbers), numbers


def test_the_bound_counts_valid_segments_only():
    cfg = spec.cell(CELL).config
    B, C, K, take, terms, T = 1024, 64, 64, 256, 3000, 16
    b = chunked.request_bound(cfg, B, C, K, take, terms, T)
    D, S, R = cfg["dim"], cfg["sketch_dim"], cfg["rows"]
    assert b["ops"] == {"bf16": 2.0 * B * S * D + 2.0 * B * R * D}
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(2.0 * B * (S + R) * D / 989e12)
    # fewer segments at the same capacity: the bound follows the segments
    fewer = dict(cfg, rows=R - R // 4)
    assert chunked.shapes(fewer)[1] == chunked.shapes(cfg)[1]
    assert chunked.request_bound(fewer, B, C, K, take, terms, T)["ops"]["bf16"] == pytest.approx(
        2.0 * B * (S + R - R // 4) * D)


def _capture(target, calls):
    def f(*a, **kw):
        calls.append((a, kw))
        return target(*a, **kw)
    return f


def test_the_system_passes_what_search_batch_passes_a_chunked_store(monkeypatch):
    from yams_tpu_torch.core.config import (EmbeddingConfig, LexicalIndexConfig,
                                            VectorIndexConfig)
    from yams_tpu_torch.search import engine as engine_mod
    from yams_tpu_torch.search.config import SearchEngineConfig
    from yams_tpu_torch.search.engine import SearchEngine

    eng = SearchEngine(config=SearchEngineConfig(batch_pad=4, approx_threshold=0,
                                                 prefilter_max_tail_ratio=0.0),
                       embedding=EmbeddingConfig(dim=64, sketch_dim=512),
                       vector=VectorIndexConfig(dim=64),
                       lexical=LexicalIndexConfig(postings_window=64), device="cpu")
    for d in range(40):
        eng.add_document(d, " ".join(f"Sentence {s} of document {d} on topic{(d + s) % 7}."
                                     for s in range(1 + d % 5)), title=f"title {d}")
    seen = []
    monkeypatch.setattr(engine_mod, "hybrid_query", _capture(engine_mod.hybrid_query, seen))
    eng.search_batch(["topic1 sentence", "document 3"], k=5)
    (e_args, e_kw), = seen

    c = tiny()
    sut = chunked.Cell(c.config, c.mix, 3, "cpu")
    got = []
    sut._hybrid_query = _capture(sut._hybrid_query, got)
    sut.request(0)
    (s_args, s_kw), = got

    assert set(s_kw) == set(e_kw)
    assert not {"rows_are_docs", "scan_block_rows"} & set(e_kw)
    for key in ("chunk_agg", "packed_lexical", "int8_corpus"):
        assert s_kw[key] == e_kw[key], key
    assert s_kw["chunk_agg"] == SearchEngineConfig().chunk_agg == c.config["chunk_agg"]
    assert len(e_args) <= 16 and len(s_args) <= 16
    assert (e_args + (None,) * 16)[15] is None and (s_args + (None,) * 16)[15] is None

    # E at the index's capacity; the doc mask and hot vector over num_slots_padded
    rows_e = int((e_args[6] >= 0).sum())
    docs_e = len(eng._doc_by_slot)
    assert rows_e > docs_e                      # several chunks a document
    assert chunked.shapes({"rows": rows_e, "published": {"segments": rows_e, "docs": docs_e}}
                          )[1:] == (e_args[4].shape[0], e_kw["num_slots"])
    assert e_args[4].shape[0] == eng.vector_index.capacity
    assert e_kw["num_slots"] == eng.num_slots_padded
    docs_s, cap_s, slots_s = chunked.shapes(c.config)
    assert s_args[4].shape[0] == cap_s and s_kw["num_slots"] == slots_s
    for args, n_slots in ((e_args, e_kw["num_slots"]), (s_args, slots_s)):
        E, valid, row2slot, row_scale = args[4:8]
        doc_mask, hot = args[12], args[13]
        assert valid.dtype == row_scale.dtype == hot.dtype == torch.float32
        assert row2slot.dtype == torch.int32 and doc_mask.dtype == torch.uint8
        assert torch.equal(row2slot < 0, valid == 0)
        assert torch.equal(row_scale, torch.ones_like(row_scale))
        assert doc_mask.shape == hot.shape == (n_slots,)
        live = row2slot[row2slot >= 0]
        assert torch.all(live[1:] >= live[:-1])    # a document's rows contiguous, in slot order
    assert int(s_args[12].sum()) == docs_s and int(e_args[12].sum()) == docs_e
