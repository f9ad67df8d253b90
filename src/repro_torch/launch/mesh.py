"""Production meshes for the dry run, and the card's constants.

The port of ``repro/launch/mesh.py``.  A mesh here is a CPU
``DeviceMesh`` over a fake process group (``FakeStore``: no rank but
this one runs, no collective moves data), the shapes and axis names the
JAX package's: ``single`` (16, 16) over ``("data", "model")``, ``multi``
(2, 16, 16) over ``("pod", "data", "model")``.  Each builder is a
context manager that sets the group up and tears it down, so no group
leaks into the caller; importing this module touches no device state.

The constants price the dry run's per-device counts on an NVIDIA H100
SXM5 at its 700 W limit, from NVIDIA's published H100 datasheet:

- ``PEAK_FLOPS_BF16`` 989e12: dense bf16 tensor-core operations a
  second;
- ``HBM_BW`` 3.35e12: HBM3 bytes a second;
- ``COLLECTIVE_BW`` 50e9: the collective term's bytes a second per GPU,
  one 400 Gb/s ConnectX-7 a GPU as a DGX H100 wires it.  Each 16-wide
  mesh axis spans two 8-GPU NVLink nodes, so every collective along it
  crosses the network, and the network link is its slowest: NVLink 4
  within a node moves 900e9 bytes a second per GPU (both directions),
  which no collective of these meshes gets end to end.
"""
from __future__ import annotations

import contextlib
import math

PEAK_FLOPS_BF16 = 989e12     # per GPU, H100 SXM5, dense bf16, 700 W
HBM_BW = 3.35e12             # bytes/s per GPU (HBM3)
COLLECTIVE_BW = 50e9         # bytes/s per GPU: one 400 Gb/s ConnectX-7


@contextlib.contextmanager
def fake_mesh(shape, axis_names):
    """A CPU ``DeviceMesh`` of ``shape`` named ``axis_names`` over a fake
    process group of ``prod(shape)`` ranks, this process rank 0; the
    group is destroyed on exit.  Raises if a group is already set up."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already set up")
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                         mesh_dim_names=tuple(axis_names))
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 GPUs; 2 pods = 512 (a context manager)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes)


def make_local_mesh():
    """The single-device mesh (a context manager)."""
    return fake_mesh((1, 1), ("data", "model"))
