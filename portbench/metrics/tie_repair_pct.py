"""tie_repair_pct.<part> (%): the share of the rows `select.top_k` selected
that it redid with unique int64 keys because a tie straddled the k-th
place: 100 x its `repair_rows` counter over its `rows`, counted since the
process began (the warm-up's requests and the window's; portbench/spans.py
`read_counters`). Nothing where the program has no such counters or the
trace holds no device activity. `.bulk` moves search_qps, `.streamed`
search_qps.streamed, `.interactive` search_p95_ms."""

from portbench.spans import read_counters


def read(run: dict) -> float | None:
    c = read_counters(run)
    return c and c["tie_repair_pct"]
