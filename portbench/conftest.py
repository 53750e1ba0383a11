"""The benchmark's own tests: ``python -m pytest portbench``. Tests that
need an NVIDIA card carry the ``card`` marker and take the ``card``
fixture, which skips them where there is none."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
