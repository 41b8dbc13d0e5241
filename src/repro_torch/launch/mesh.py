"""Meshes of the sharded forest trainer.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
dimensions ``("data", "model")`` over an initialised process group, one
rank per device: rows are sharded over ``data``, the ensembles of a batch
over ``model``. The trainer reads ``mesh.get_group("data")`` and
``mesh.get_group("model")``. Defined as functions, so importing touches no
device and no process group.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.dispatch import Device, resolve_device

DIMS = ("data", "model")


def forest_mesh(n_data: int, n_model: int, device: Optional[Device] = None):
    """A ``n_data`` × ``n_model`` mesh over the initialised process group
    (its world size must be ``n_data · n_model``; rank ``r`` sits at data
    ``r // n_model``, model ``r % n_model``), on ``device``'s type
    (``None``: the GPU, or raise)."""
    from torch.distributed.device_mesh import DeviceMesh
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("forest_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} "
                         f"ranks; the process group has {world}")
    ranks = torch.arange(world).reshape(n_data, n_model)
    return DeviceMesh(device.type, ranks, mesh_dim_names=DIMS)


def auto_forest_mesh(model_axis_max: int = 8):
    """A (data, model) mesh over every visible GPU, by the JAX package's
    rule: the model dimension gets the largest power of two that divides
    the device count, is at most ``model_axis_max`` and stays at most the
    data dimension. ``None`` on one device or none (callers then take the
    single-device trainer); more needs a process group of one rank per
    GPU (``torchrun``)."""
    n = torch.cuda.device_count()
    if n <= 1:
        return None
    model = 1
    while (model * 2 <= model_axis_max and (model * 2) ** 2 <= n
           and n % (model * 2) == 0):
        model *= 2
    return forest_mesh(n // model, model, "cuda")
