"""Pytest settings of the benchmark's tests: the repository's `gpu` marker, registered here
too so that these tests run on their own (python -m pytest bench/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips inside the test where torch.cuda.is_available() "
        "is false",
    )
