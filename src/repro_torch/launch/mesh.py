"""Mesh construction (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the process group the caller initialized, with the reference's axis
names: 'pod' (across pods), 'data' (data parallel / FSDP) and 'model'
(tensor, expert and sequence parallel).  Functions, not module state:
importing touches no process group.  The mesh's device type follows the
group's backend: CUDA under NCCL (each rank on its own card), the CPU
under gloo.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_production_mesh", "make_test_mesh"]


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A DeviceMesh of ``shape`` named ``axes`` over every rank of the
    default process group, ranks laid out row-major.  Raises
    ``ValueError`` unless a group of exactly ``prod(shape)`` ranks is
    initialized."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(
            f"a mesh of shape {shape} {axes} needs a process group of "
            f"{need} ranks, found {have or 'none'} (init_process_group "
            f"with world_size={need} first)")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 ('data', 'model'), or 2 x 16 x 16 ('pod', 'data', 'model')
    for two pods."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_test_mesh(data: int = 2, model: int = 4, pod: int = 0):
    """A small mesh: (data, model), or (pod, data, model) when ``pod``."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))
