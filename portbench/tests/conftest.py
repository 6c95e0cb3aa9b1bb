"""The `card` marker: a test that needs a CUDA device decides inside itself
whether one is there, and skips with a reason where there is none."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
