"""Fixtures shared by the port's serving-system tests."""
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

# the ops that read a device value back to the host
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "item"}


class NoHostRead(TorchDispatchMode):
    """Raise on any op that reads a device value back to the host: a CUDA
    graph cannot capture it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in HOST_READS:
            raise AssertionError(f"host read inside a program body: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the reduced model's small eager ops: the
    test workers share the machine's cores, and eight threads a worker
    oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
