"""chunk_score_gb.<part> (GB/request): the bytes of (B, rows) f32 chunk
scores the program's chunked path wrote or read between the product and the
selection (`yams_tpu_torch.search.fusion.chunk_score_bytes`: the product's
write, the validity bias's read and write, each aggregation pass) over the
requests it took (`fusion.hybrid_query_calls`), both counted since the
process began, so over the warm-up's requests and the window's, all of one
shape, as `host_syncs` counts. 1 GB is 1e9 bytes. Nothing where the program
has no such counter or the trace holds no device activity. `.chunked`
moves search_qps."""

import sys


def read(run: dict) -> float | None:
    tr = run.get("trace")
    fusion = sys.modules.get("yams_tpu_torch.search.fusion")
    n = getattr(fusion, "chunk_score_bytes", None)
    calls = getattr(fusion, "hybrid_query_calls", None)
    if not tr or tr["busy_s"] is None or not isinstance(n, int) or not isinstance(calls, int):
        return None
    return n / calls / 1e9 if calls else None
