"""Meshes: the sharded forest trainer's, the LM's production meshes and a
small debug mesh.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
dimensions ``("data", "model")`` over an initialised process group, one
rank per device: rows are sharded over ``data``, the ensembles of a batch
over ``model``. The trainer reads ``mesh.get_group("data")`` and
``mesh.get_group("model")``. The LM's meshes (:func:`make_production_mesh`,
:func:`make_debug_mesh`) carry the JAX package's axis names, and
:mod:`repro_torch.sharding.rules` lays parameters, batches and caches out
on them. Defined as functions, so importing touches no device and no
process group.
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


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_backend() == "fake":
        # a fake group (the dry run) runs no device: take the type as given
        device = torch.device(device or "cuda")
    else:
        device = resolve_device(device)
    world, need = dist.get_world_size(), 1
    for n in shape:
        need *= n
    if need != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {need} "
                         f"ranks; the process group has {world}")
    return DeviceMesh(device.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Device] = None):
    """16x16 ``("data", "model")`` (256 ranks) or 2x16x16 ``("pod",
    "data", "model")`` (512 ranks) over the initialised process group,
    whose world size must match; on ``device``'s type (``None``: the GPU,
    or raise)."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), DIMS, device)


def make_debug_mesh(n_data: int = 4, n_model: int = 2,
                    device: Optional[Device] = None):
    """A small ``n_data`` x ``n_model`` ``("data", "model")`` mesh for tests
    and one card (world size ``n_data · n_model``)."""
    return _mesh((n_data, n_model), DIMS, device)


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
