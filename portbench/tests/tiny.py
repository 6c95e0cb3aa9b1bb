"""Cells of BENCHMARK.json cut to a size a CPU test holds: the same files,
every width and count cut (rows, dim, sketch, vocabulary, postings, batch,
candidates), and the port's streaming scan turned on below its threshold."""

from __future__ import annotations

import copy
import types

from portbench import spec

ENGINE = types.SimpleNamespace(chunk_agg="max", streaming_threshold=8192,
                               streaming_block_rows=4096)


def tiny(cell_name: str) -> spec.CellSpec:
    c = spec.cell(cell_name)
    cfg = copy.deepcopy(c.config)
    cfg.update(rows=16384 if cfg["dtype"] == "int8" else 12288, dim=64, sketch_dim=256)
    cfg["corpus"].update(block_rows=4096, centers=64)
    cfg["lexical"].update(terms=512, postings_window=64, postings_per_term=32)
    mix = copy.deepcopy(c.mix)
    mix.update(batch=8, pool_batches=4, sample_requests=3)
    mix["search"].update(rrf_cand=16, device_k=16, bm25_prefilter=16)
    return spec.CellSpec(c.name, 1, cfg, mix, c.limits, c.tie_eps, c.end_to_end, c.per_layer)
