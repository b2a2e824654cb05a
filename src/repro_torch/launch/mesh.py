"""Mesh builders (counterpart of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device.

The LM zoo's meshes (``make_production_mesh``, ``make_test_mesh``) are
``DeviceMesh``es over the current ``torch.distributed`` world, whose
size must be the mesh's: one rank a device, on the card over NCCL
(``cuda``), on the CPU over gloo.  The dry-run has no such world: it
calls ``fake_world(n)`` first, a process group of ``n`` ranks in this
one process that moves no data, so that shapes, plans, byte counts and
FLOP counts can be taken on local shards on the meta device.  No number
that is compared with a computed result comes from it.

The data and replica meshes are the streaming and serving topologies of
one process (``DataMesh``, a list of devices).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.devices import DeviceLike, replica_devices, visible_devices
from repro_torch.distributed.runtime import DataMesh


def fake_world(world_size: int) -> None:
    """A process group of ``world_size`` ranks in this process, this
    one rank 0, that moves nothing (``torch.testing``'s fake backend):
    for the dry-run's shapes and counts only.  An existing world of
    another size raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a world of {dist.get_world_size()} ranks is up; the "
                f"dry-run needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _world_device_type() -> str:
    import torch.distributed as dist
    backend = str(dist.get_backend()).lower()
    return "cuda" if backend == "nccl" else "cpu"


def _make_mesh(shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} {axes} mesh needs a "
            f"torch.distributed world of {n} ranks (init_process_group; "
            "the dry-run uses launch/mesh.py::fake_world)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"the mesh {dict(zip(axes, shape))} needs {n} "
                           f"ranks, the world has {dist.get_world_size()}")
    return init_device_mesh(_world_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 ``("data", "model")`` or 2×16×16 ``("pod", "data",
    "model")`` over the current world (256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_test_mesh(data: int = 4, model: int = 2):
    """A small ``("data", "model")`` mesh over the current world of
    ``data·model`` ranks."""
    return _make_mesh((data, model), ("data", "model"))


def _n_devices(n_devices: Optional[int], device: DeviceLike) -> int:
    """``n_devices``, or every visible device (``replica_devices`` checks
    that there are enough)."""
    return visible_devices(device) if n_devices is None else int(n_devices)


def make_data_mesh(n_devices: Optional[int] = None,
                   device: DeviceLike = None) -> DataMesh:
    """The data-parallel streaming topology of one process
    (``train.data_parallel``): batches split over ``n_devices`` devices
    from ``device`` on (all visible cards by default), params replicate,
    gradients all-reduce with ``psum_mean``.  On the CPU the devices are
    ``n_devices`` handles to the CPU."""
    devs = tuple(replica_devices(device, _n_devices(n_devices, device)))
    return DataMesh(devices=devs,
                    placement=tuple((0, str(d)) for d in devs))


def make_replica_mesh(n_replicas: Optional[int] = None,
                      device: DeviceLike = None) -> List[torch.device]:
    """The serving replica topology
    (``serving.HashedClassifierEngine(replicas=N)``): one model copy a
    device, no collectives."""
    return replica_devices(device, _n_devices(n_replicas, device))
