import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

THETA_1 = [[0.15, 0.70], [0.70, 0.85]]


def tiny(config: dict) -> dict:
    """A configuration file cut to a size the CPU samples in milliseconds."""
    if config["model"] == "magm":
        return dict(config, d=8, num_nodes=256)
    return dict(config, d=9, num_nodes=512)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture(autouse=True)
def one_thread():
    """The harness's tests drive tiny shapes, on which PyTorch's CPU thread
    pool only contends with the other test workers: run them on one
    thread, and give the pool back after each test."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
