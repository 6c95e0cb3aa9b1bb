"""device_idle_pct.<part> (%): 100 less the share of the traced window that
the union of the device's operations covers (torch.profiler, device activity
only). `.bulk` moves search_qps, `.interactive` search_p95_ms."""

from portbench.trace import idle_pct as read  # noqa: F401
