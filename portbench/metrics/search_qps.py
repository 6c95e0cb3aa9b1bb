"""search_qps (queries/s): the queries completed in the window over the
window's seconds, by the host's clock."""


def read(run: dict) -> float | None:
    return run["queries"] / run["window_s"] if run["window_s"] > 0 else None
