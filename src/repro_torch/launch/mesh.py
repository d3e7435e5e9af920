"""Production mesh construction.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks.

A ``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, which the caller initialises (``torch.distributed``
``init_process_group`` with its rank and world size): one rank per
card.  FUNCTIONS, not module constants: importing this module touches no
process group."""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_test_mesh", "dp_axes", "MODEL_AXIS",
           "one_rank_group"]

MODEL_AXIS = "model"


def _mesh(shape: tuple, axes: tuple, device_type: str) -> DeviceMesh:
    size = 1
    for n in shape:
        size *= n
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != size:
        raise RuntimeError(
            f"a {shape} mesh over {axes} needs a world of {size} ranks; "
            + ("no process group is initialised" if world is None
               else f"this one has {world}"))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for tests: gloo ranks on the CPU (``device_type="cpu"``)
    or NCCL ranks on cards."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except 'model')."""
    return tuple(a for a in mesh.mesh_dim_names if a != MODEL_AXIS)


@contextlib.contextmanager
def one_rank_group(device_type: str = "cuda"):
    """A default process group of one rank, for a mesh of one rank in
    this process (``make_test_mesh(data=1, model=1)``): NCCL on the
    current card, gloo on the CPU, over an in-process store; destroyed on
    exit."""
    if device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
