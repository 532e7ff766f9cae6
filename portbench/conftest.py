"""pytest settings of the benchmark's own tests (`python -m pytest
portbench/tests`). Tests marked `card` need an NVIDIA card; each decides
inside the test whether one is present and skips otherwise."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (runs on the chip only)")
