"""Process meshes over ``torch.distributed`` (port of ``parallel/mesh.py``).

The reference is single-device (one Device and one Stream,
app/main.cpp:162-163). Here every rank is one process that drives one
device; a mesh is a ``DeviceMesh`` over the world's ranks, whose axes name
the process groups the sharded render and training step talk over ("gs":
gaussian and tile sharding, "data": view data-parallelism). The caller
starts the process group and chooses its backend: NCCL for CUDA tensors,
gloo for CPU tensors. Nothing here switches backends.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] = ("gs",),
              device: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the started process group, in row-major
    rank order (rank ``data * n_gs + gs`` sits at ``(data, gs)``, the order
    of the JAX package's ``np.asarray(devices).reshape(shape)``).

    ``shape`` defaults to one axis over the world; ``device`` is the device
    type of the ranks' tensors ("cuda" or "cpu"). For "cuda" the rank's
    current device is kept if the caller set one (``torch.cuda.set_device``).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: start the process group first "
                           "(initialize_multihost)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does "
                         f"not cover the {world} ranks")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axis_names))


def initialize_multihost(init_method: str = "env://",
                         world_size: int | None = None,
                         rank: int | None = None,
                         backend: str = "nccl"):
    """Start the process group: a thin wrapper over
    ``dist.init_process_group``. ``env://`` reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (what ``torchrun`` sets);
    pass ``tcp://host:port`` or ``file://path`` with the world size and rank
    otherwise. Returns (rank, world size)."""
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend=backend, init_method=init_method, **kw)
    return dist.get_rank(), dist.get_world_size()


def join_process_group(device: str):
    """The process group of a CLI run with ``--shard``: under ``torchrun``
    (``WORLD_SIZE`` > 1) it is started here from ``env://``, with NCCL for
    a CUDA device and gloo for the CPU; a group the caller started is used
    as it is. A bare "cuda" becomes the rank's ``cuda:LOCAL_RANK``.

    Returns (rank, world size, the rank's torch.device, whether this call
    started the group)."""
    dev = torch.device(device)
    started = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        initialize_multihost(backend="nccl" if dev.type == "cuda" else "gloo")
        started = True
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        return 0, 1, dev, started
    return dist.get_rank(), dist.get_world_size(), dev, started
