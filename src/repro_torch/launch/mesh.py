"""Production mesh construction (reference `repro/launch/mesh.py`) on torch's
`DeviceMesh`. The meshes are made in functions, so importing this module
touches no process group.

A mesh needs a default process group of the mesh's world size. Under
torchrun that is the real one. Otherwise `world(n)` owns one: torch's
"fake" backend, on which this process is rank 0 of n and every collective
is a no-op (an all-gather copies the local shard into each slot, a reduce
leaves it as it is), so rank 0's local program runs alone: on meta tensors
for the dry run's estimate, or on the card for its measured peak.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

PRODUCTION = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))
HOST = ((1, 1), ("data", "model"))


def world_size(*, multi_pod: bool = False) -> int:
    shape, _ = MULTI_POD if multi_pod else PRODUCTION
    n = 1
    for s in shape:
        n *= s
    return n


@contextlib.contextmanager
def world(n: int):
    """A default process group of `n` ranks for the block. An initialised
    group (torchrun) is used as it is and must have `n` ranks; otherwise a
    fake group is made, this process as rank 0, and destroyed on exit,
    whatever the block raised."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"the initialised process group has "
                               f"{dist.get_world_size()} ranks; this mesh "
                               f"needs {n}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(spec, device: str):
    shape, names = spec
    # DeviceMesh places a mesh on a device type; meta tensors ride on a CPU
    # mesh (the mesh only routes collectives, which the fake group drops).
    dev = "cpu" if device == "meta" else device
    return init_device_mesh(dev, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model").
    Needs a default group of that size (`world`)."""
    return _mesh(MULTI_POD if multi_pod else PRODUCTION, device)


def make_host_mesh(device: str = "cuda"):
    """Single-device (1, 1) mesh with the production dim names, so the same
    placement code runs everywhere. Needs a default group of one rank."""
    return _mesh(HOST, device)


__all__ = ["world", "world_size", "make_production_mesh", "make_host_mesh"]
