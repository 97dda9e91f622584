"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``card`` marker, for tests that need a CUDA card and
skip without one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")
