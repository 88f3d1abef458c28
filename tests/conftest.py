import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration tests")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
