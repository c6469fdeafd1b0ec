"""The benchmark's own tests.  ``chip``: a test that needs a CUDA card; it
decides inside the test whether there is one and skips on the CPU."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")
