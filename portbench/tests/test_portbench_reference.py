"""The plain reference, its control and the generators, at sizes a CPU test
holds: the port's CPU route of `hybrid_query` agrees with the reference for
both configurations, the lower-precision control does not."""

from __future__ import annotations

import pytest
import torch

from portbench import control, data
from portbench.reference import hybrid as ref
from portbench.tests.tiny import ENGINE, tiny

CONFIGS = ["hybrid1m-bf16.bulk", "int8-10m.bulk"]   # one cell of each configuration


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
@pytest.mark.parametrize("cell", CONFIGS)
def test_the_port_agrees_with_the_reference_and_the_control_does_not(cell, seed):
    c = tiny(cell)
    r = control.readings(c, seed, True, "cpu", ENGINE)
    assert r["queries"] == c.mix["batch"] * c.mix["sample_requests"]
    for name, lim in c.limits.items():
        assert r["program"][name] <= lim["limit"], (name, r["program"])
    failed = [n for n, lim in c.limits.items() if r["control"][n] > lim["limit"]]
    assert {"vec_gap", "bm25_gap", "fused_gap"} <= set(failed), r["control"]


def _inputs(packed: torch.Tensor, N: int, dtype: str = "bf16") -> ref.Inputs:
    D = 8
    E = torch.nn.functional.normalize(torch.randn(N, D), dim=1).to(torch.bfloat16)
    return ref.Inputs(dtype=dtype, E=E, row_scale=torch.ones(N), row_valid=torch.ones(N),
                      doc_mask=torch.ones(N, dtype=torch.uint8), hot=torch.zeros(N),
                      proj=torch.eye(D, dtype=torch.bfloat16), packed=packed,
                      impact_scale=2.0, qbits=data.packed_qbits(N), weights={})


def test_lexical_sums_are_exact_and_ties_go_to_the_lower_doc():
    N = 100
    qb = data.packed_qbits(N)
    key = lambda doc, q: (doc << qb) | q          # noqa: E731
    sink = N << qb
    packed = torch.tensor([[key(7, 5), key(3, 4), key(9, 4), sink],
                           [key(9, 1), key(3, 1), key(50, 3), sink]], dtype=torch.int32)
    inp = _inputs(packed, N)
    tids = torch.tensor([[0, 1, 0]], dtype=torch.int32)
    tmask = torch.tensor([[1.0, 1.0, 0.0]])
    lex = ref.lexical(inp, tids, tmask, take=3, depth=4, precision="config")
    unit = 2.0 / ((1 << qb) - 1)
    # doc 3: 4 + 1, doc 9: 4 + 1, doc 7: 5, doc 50: 3 (term 1 cut at 3 postings)
    assert lex.top_i.tolist() == [[3, 7, 9, 50]]
    assert lex.top_v[0].tolist() == pytest.approx([5 * unit, 5 * unit, 5 * unit, 3 * unit])
    assert lex.at(torch.tensor([[9, 50, 1]]))[0].tolist() == pytest.approx([5 * unit, 3 * unit, 0.0])


def test_packed_key_layout_is_the_ports():
    from yams_tpu_torch.ops.bm25 import packed_qbits

    for n in (1, 100, 65_536, 1_000_448, 10_485_760):
        assert data.packed_qbits(n) == packed_qbits(n)


def test_int8_rows_are_quantized_as_the_stored_index_quantizes():
    import numpy as np
    from yams_tpu_torch.ops.scan import quantize_int8

    x = torch.randn(64, 32)
    q, s = data.quantize_int8_rows(x)
    q_ref, s_ref = quantize_int8(x.numpy())
    assert np.array_equal(q.numpy(), q_ref) and np.array_equal(s.numpy(), s_ref)


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_query_pool_has_the_same_lengths_for_every_seed(seed):
    query = tiny("hybrid1m-bf16.bulk").mix["query"]
    gen = torch.Generator().manual_seed(seed)
    _, tids, tmask = data.query_pool(gen, "cpu", 640, 16, 512, query)
    lengths = (tmask > 0).sum(dim=1)
    counts = data.length_counts(640, query["term_count_weights"])
    assert torch.bincount(lengths, minlength=17)[1:].tolist() == counts
    for row, m in zip(tids.tolist(), tmask.tolist()):
        n = int(sum(m))
        assert m[:n] == [1.0] * n and row[n:] == [0] * (16 - n)
        assert len(set(row[:n])) == n


def test_length_counts_split_exactly():
    assert data.length_counts(10, [1, 1, 1]) == [4, 3, 3]
    assert sum(data.length_counts(8192, [22, 26, 20, 12, 7, 4.5, 3, 2, 1.2, 0.8, 0.5,
                                         0.4, 0.25, 0.15, 0.1, 0.1])) == 8192
