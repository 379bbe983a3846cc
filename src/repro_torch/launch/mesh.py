"""Production mesh construction over ``torch.distributed``.

Importing this module touches no process group. A mesh is a
``DeviceMesh`` with named dims over the process group of the caller:
:func:`make_mesh` needs ``torch.distributed`` initialised with as many
ranks as the mesh has (NCCL on the card, gloo on the CPU, or the fake
group of :func:`init_fake_world` for the dry run); :func:`set_mesh` makes
a mesh the one the model code reads
(:func:`repro_torch.models.common.current_mesh`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.common import use_mesh


def make_mesh(shape, axes, device_type: str = "cuda", ranks=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes``: over every
    rank of the default process group
    (``torch.distributed.device_mesh.init_device_mesh``), or over the
    first ``prod(shape)`` of them given ``ranks`` (as the reference's
    ``devices=``; every rank makes the mesh, as it makes any group)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if ranks is None:
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    ranks = torch.as_tensor(list(ranks)).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def set_mesh(mesh):
    """Context manager: ``mesh`` is the current mesh for the block."""
    return use_mesh(mesh)


def production_shape(multi_pod: bool = False):
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod. Axes:
    ``data`` = FSDP/batch, ``model`` = TP, ``pod`` = pure DP across
    pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device_type)


def make_mesh_for(n_devices: int, model_parallel: int = None,
                  device_type: str = "cuda"):
    """Elastic helper: largest (data, model) mesh for the devices
    present."""
    model_parallel = model_parallel or min(n_devices, 16)
    while n_devices % model_parallel:
        model_parallel //= 2
    return make_mesh((n_devices // model_parallel, model_parallel),
                     ("data", "model"), device_type)


def init_fake_world(world_size: int) -> None:
    """Open the fake process group of ``world_size`` ranks that the dry
    run traces on: this process is rank 0, and every collective completes
    at once without moving data. A process opens one group in its life,
    so the dry run runs in a process of its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
