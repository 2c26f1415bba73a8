"""Meshes over ``torch.distributed``.

The port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the current world, one
rank a device: NCCL on the CUDA card, gloo on the CPU (``device="cpu"``).
Nothing on a machine tells a program of its cluster, so a world starts
from a ``file://`` store in a directory the caller names
(:func:`init_world`); two worlds in two directories never collide, as
parallel test workers would on a TCP port.

``make_production_mesh`` and ``make_local_mesh`` are functions: importing
this module starts nothing.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import tempfile
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve

WORLD_TIMEOUT_S = 300.0


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_world(store_dir: str, rank: int = 0, world_size: int = 1,
               device: DeviceLike = None,
               timeout_s: float = WORLD_TIMEOUT_S) -> str:
    """Start this process's ``rank`` of a world of ``world_size`` ranks
    from a ``file://`` store in ``store_dir``: NCCL on the CUDA card (the
    default, raising if there is none), gloo for ``device="cpu"``.  A
    collective that waits longer than ``timeout_s`` raises.  -> the
    backend's name."""
    dev = resolve(device)
    backend = _backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    os.makedirs(store_dir, exist_ok=True)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


@contextlib.contextmanager
def local_world(device: DeviceLike = None) -> Iterator[str]:
    """A world of one rank for the block, from a store in a temporary
    directory, torn down after it; a world already started is used as it
    is and left running.  -> the backend's name."""
    if dist.is_initialized():
        yield dist.get_backend()
        return
    with tempfile.TemporaryDirectory() as d:
        backend = init_world(d, device=device)
        try:
            yield backend
        finally:
            dist.destroy_process_group()


def _world(dev: torch.device, n: int) -> None:
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a world of {n}: start one with "
                f"launch.mesh.init_world on every rank")
        init_world(tempfile.mkdtemp(prefix="mesh-"), device=dev)
    want = _backend(dev)
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"a mesh on {dev.type} needs the {want} backend; "
                           f"the world runs {have}")


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2x16x16 =
    512 ranks (pod, data, model) — "pod" is the slow inter-pod dimension
    and only ever carries data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} ranks (start a world of {n} with "
            f"launch.mesh.init_world on every rank); have {have}")
    dev = resolve(device)
    _world(dev, n)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1, data: int = 1,
                    device: DeviceLike = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the current world, which must hold
    ``data * model`` ranks; with none started and a mesh of one, a world
    of one rank starts here.  On the CUDA card over NCCL (the default,
    raising if there is no card), over gloo for ``device="cpu"``."""
    return make_mesh((data, model), ("data", "model"), device)


def make_mesh(shape, names, device: DeviceLike = None) -> DeviceMesh:
    """Any mesh shape over the whole current world (``repro``'s tests and
    benchmarks build ``Mesh(devices.reshape(shape), names)``)."""
    dev = resolve(device)
    n = math.prod(shape)
    _world(dev, n)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs a world of {n}; "
                           f"have {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(names))

