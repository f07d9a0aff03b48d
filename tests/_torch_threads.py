"""The torch-port test files' share of the CPU in the tier-1 run: six xdist
workers share the machine's cores, and a torch process otherwise starts
one OpenMP thread per core, so the workers' spinning threads keep each
other (and the JAX workers) waiting. Importing `few_threads` into a test
module runs that module's tests with TEST_THREADS intra-op threads and
gives the process its threads back afterwards.

Two files keep the default: tests/test_torch_train_step.py and
tests/test_torch_pointnet_dgcnn.py hold float32 gradients to JAX at bars
that the summation order of another thread count crosses (a float32
PointNet grad_norm at 1.06e-3 of its 1e-3 bar with two threads)."""
import pytest
import torch

TEST_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TEST_THREADS))
    yield
    torch.set_num_threads(n)
