"""Pytest settings: registers the `gpu` marker (tests that need an NVIDIA card)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips inside the test where torch.cuda.is_available() "
        "is false (run on the card: python -m pytest -q -m gpu tests/test_torch_gpu.py)",
    )
