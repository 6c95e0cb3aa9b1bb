"""host_syncs.<part> (syncs/request): the times a request makes the host
wait for the card inside the program: the program's `syncs` counters
(`yams_tpu_torch.ops.select.top_k`'s `nonzero`, one a call, and in the
int8 cells `ops.scan.quantize_rows`'s divisor copy, one a request; the
trace's synchronizing calls agree, `portbench/spans.py`) over the
requests it took (`search.fusion.hybrid_query_calls`), both counted
since the process began, so over the warm-up's requests and the window's,
all of one shape (portbench/spans.py `read_counters`). Nothing where the
program has no such counters or the trace holds no device activity.
`.bulk` moves search_qps, `.streamed` search_qps.streamed, `.interactive`
search_p95_ms."""

from portbench.spans import read_counters


def read(run: dict) -> float | None:
    c = read_counters(run)
    return c and c["host_syncs"]
