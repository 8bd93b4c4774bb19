"""Device meshes over ``torch.distributed``.

Port of ``repro/launch/mesh.py``.  A mesh is PyTorch's own
``torch.distributed.device_mesh.DeviceMesh`` with named dims, used in
SPMD style: every rank of the process group calls the same entry point
with the same global input, computes its share, and returns the whole
result (the array the reference's single-controller call returns).

Defined as functions (never module-level constants) so importing this
module touches no process group and no device.

Single pod: (data=16, model=16) — 256 devices.  Multi-pod: (pod=2,
data=16, model=16) — 512 devices; the pod axis is pure data parallelism.

Planning: :func:`make_fake_mesh` starts a ``fake`` process group of
``prod(shape)`` ranks in this process, as rank 0, whose collectives move
nothing; the dry run (``launch/dryrun.py``) plans the 256- and 512-rank
production meshes on it with fake tensors, allocating nothing.

Launching: ``torchrun --nproc-per-node N`` starts N ranks that each call
:func:`make_mesh` with a shape of N devices; a single process asks for a
one-rank mesh and :func:`make_mesh` starts its one-rank group itself.
NCCL takes one card per rank, so ranks that share a card (several ranks
on one GPU) need the ``gloo`` backend, which moves CUDA tensors through
host memory.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_production_mesh", "make_local_mesh",
           "mesh_device", "make_fake_mesh"]


def _local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` (torchrun sets it),
    else the global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _check_cuda() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device_type='cpu' for a mesh "
            "of CPU ranks (gloo)")
    return torch.cuda.device_count()


def make_mesh(shape, axes, *, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes``.

    ``device_type`` is ``"cuda"`` (the default; raises without a card) or
    ``"cpu"`` when asked for.  With no default process group and a shape
    of one device, it starts a one-rank group itself (``nccl`` on
    ``cuda``, ``gloo`` on the CPU, a local store).  Otherwise the
    launched world must hold exactly ``prod(shape)`` ranks.  On ``cuda``
    each rank takes card ``local_rank % device_count``; under ``nccl``
    the ranks of a host must not outnumber its cards.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axis names {axes}")
    device_type = device_type or "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device type {device_type!r}")
    cards = _check_cuda() if device_type == "cuda" else 0
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} devices needs a launched process group of "
                f"{n} ranks (torchrun --nproc-per-node {n}, or "
                f"torch.distributed.init_process_group); only a one-device "
                f"mesh starts its own")
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {n} ranks; the process "
            f"group has {world}")
    if device_type == "cuda":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if "nccl" in str(dist.get_backend()) and local_world > cards:
            raise ValueError(
                f"nccl takes one card per rank: {local_world} ranks on a "
                f"host with {cards} card(s); start the group with the gloo "
                f"backend to share a card between ranks")
        torch.cuda.set_device(_local_rank() % cards)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on within ``mesh``: the CPU for a CPU
    mesh, card ``local_rank % device_count`` for a CUDA one."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", _local_rank() % _check_cuda())


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None, fake: bool = False):
    """The single-pod (data=16, model=16) or multi-pod (pod=2, data=16,
    model=16) mesh: over the launched ranks, or with ``fake`` over a
    planning world of that many ranks (:func:`make_fake_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if fake:
        return make_fake_mesh(shape, axes)
    return make_mesh(shape, axes, device_type=device_type)


def make_fake_mesh(shape, axes):
    """A CPU ``DeviceMesh`` of ``shape`` over a ``fake`` process group of
    ``prod(shape)`` ranks in this process, which is its rank 0.  Every
    collective over it returns at once and moves nothing, so a step run
    over fake tensors on it plans rank 0's share of a mesh of any size
    (the reference's ``--xla_force_host_platform_device_count``).  A
    default group of another kind or size must not be running; an
    earlier fake group of another size is replaced."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running; plan in a "
                               "process of its own")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str | None = None):
    """A (data, model) mesh over the launched ranks (tests, one host)."""
    return make_mesh((data, model), ("data", "model"),
                     device_type=device_type)
