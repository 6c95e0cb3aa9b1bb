"""hybrid_query_roofline.<part> (%): the least device time the traced
requests need (portbench/systems/hybrid.py `request_bound`,
portbench/peaks.py) over the device's busy time in the traced window.
`.bulk` moves search_qps, `.interactive` search_p95_ms."""

from portbench.trace import roofline_pct as read  # noqa: F401
