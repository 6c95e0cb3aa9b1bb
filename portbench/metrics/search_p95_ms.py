"""search_p95_ms (ms): the 95th percentile (nearest rank) of the latencies of
all requests completed in the window, by the host's clock."""

import math


def read(run: dict) -> float | None:
    lat = sorted(run["latencies_s"])
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
