"""Test settings of the port's benchmark: the card-only marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA CUDA card; skipped where torch.cuda is unavailable")
