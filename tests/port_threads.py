"""The port test modules' thread policy, without JAX: ``torch_threads`` caps
torch's CPU threads at ``TORCH_THREADS`` for a test module. The suite runs
several workers on one machine, each with its own thread pools, and the
port's models run many small ops, which a full thread pool slows down by an
order of magnitude beside the other workers. ``tests/torch_port.py``
re-exports it; a module that must not import JAX imports it from here."""
import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)
