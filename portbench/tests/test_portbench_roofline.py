"""The least time a request needs, worked out by hand for each cell."""

from __future__ import annotations

import pytest

from portbench import peaks, spec
from portbench.systems.hybrid import request_bound

HBM = 3.35e12


def _bound(cell: str, terms: int) -> dict:
    c = spec.cell(cell)
    s = c.mix["search"]
    return request_bound(c.config, c.mix["batch"], s["rrf_cand"], s["device_k"],
                         s["bm25_prefilter"], terms, c.mix["query"]["max_terms"])


def test_peaks_are_the_data_sheets():
    assert peaks.PEAK_OPS == {"bf16": 989e12, "int8": 1979e12}
    assert peaks.PEAK_BYTES == HBM


def test_hybrid1m_bulk_is_bound_by_the_bf16_products():
    b = _bound("hybrid1m-bf16.bulk", terms=1000)
    # scores 2 * 1,024 * 1,000,448 * 768 plus the embed 2 * 1,024 * 4,096 * 768
    ops = 1_573_568_643_072 + 6_442_450_944
    assert b["ops"] == {"bf16": ops}
    nbytes = (1_000_448 * 768 * 2 + 1_000_448 * 4 + 1_000_448 + 4096 * 768 * 2
              + 1024 * 4096 * 4 + 1024 * 16 * 8 + 1000 * 256 * 4 + 1024 * 128 * 4
              + 1024 * 64 * 16)
    assert b["bytes"] == nbytes == 1_567_486_976
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(ops / 989e12, rel=1e-12)
    assert b["bound_s"] == pytest.approx(1.597585e-3, rel=1e-6)


def test_int8_10m_interactive_is_bound_by_the_corpus_bytes():
    c = spec.cell("int8-10m.interactive")
    B = c.mix["batch"]
    b = _bound("int8-10m.interactive", terms=300)
    N = 10_485_760
    nbytes = (N * 768 + N * 4 + N * 4 + N + 4096 * 768 * 2 + B * 4096 * 4 + B * 16 * 8
              + 300 * 256 * 4 + B * 128 * 4 + B * 64 * 16)
    assert b["bytes"] == nbytes
    assert b["ops"] == {"bf16": 2.0 * B * 4096 * 768, "int8": 2.0 * B * N * 768}
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(nbytes / HBM, rel=1e-12)
    assert 2.43e-3 < b["bound_s"] < 2.45e-3


def test_int8_10m_bulk_is_bound_by_the_int8_products():
    b = _bound("int8-10m.bulk", terms=1000)
    int8_ops = 16_492_674_416_640          # 2 * 1,024 * 10,485,760 * 768
    embed = 6_442_450_944                   # 2 * 1,024 * 4,096 * 768, bf16
    assert b["ops"] == {"bf16": embed, "int8": int8_ops}
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(int8_ops / 1979e12 + embed / 989e12, rel=1e-12)
    assert b["bound_s"] == pytest.approx(8.340357e-3, rel=1e-6)
