"""setup_s (s): from the harness's first line to the end of the warm-up: the
imports, the device's context, the data made from the seed, the warm-up
requests."""


def read(run: dict) -> float | None:
    return run["setup_s"]
