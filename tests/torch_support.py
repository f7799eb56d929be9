"""Fixtures shared by the port's serving-system tests."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the reduced model's small eager ops: the
    test workers share the machine's cores, and eight threads a worker
    oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
