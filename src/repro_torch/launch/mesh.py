"""Meshes: a ``DeviceMesh`` over the process group, or the production
meshes' axis names and sizes.

Counterpart of ``repro/launch/mesh.py``.  ``make_production_mesh`` gives
(16, 16) = ("data", "model") single-pod and (2, 16, 16) = ("pod", "data",
"model") multi-pod as an ``AbstractMesh`` (names and sizes, no devices:
one host cannot hold 256 ranks); the dry run reads only its names and
sizes.  ``make_test_mesh`` builds a real ``DeviceMesh`` over the process
group, starting a world of one where none is running: NCCL on the card,
gloo on the CPU, each from an in-process ``HashStore`` (no TCP port).  A
world of more ranks is started by its launcher with
``torch.distributed.init_process_group`` (its address, size and rank
given) before the mesh is made.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.sharding import AbstractMesh, chips  # noqa: F401


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None):
    """A (data, model) ``DeviceMesh`` over the process group's ranks, on
    ``device``'s type (default CUDA).  Without a process group it starts
    a world of one; a mesh of another size than the world raises."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    n = data * model
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a ({data}, {model}) mesh takes {n} ranks, and no process "
                "group is running: start one with a rank a process first")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a ({data}, {model}) mesh takes {n} ranks; the "
                         f"process group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else
                              dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
