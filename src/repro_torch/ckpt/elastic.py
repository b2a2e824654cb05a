"""Elastic data parallelism: fold a logical data world onto the devices
that are alive, and move a restored host tree onto them (counterpart of
``repro/ckpt/elastic.py``).

Checkpoints are topology-free host arrays.  ``train.streaming
.fit_streaming(elastic=True)`` keeps the LOGICAL data-parallel world
(the shard-group schedule, pinned by the run fingerprint) and folds
``logical // physical`` shard slots onto each live device
(``physical_data_world``; across a gang, ``process_fold``); ``reshard``
puts a restored tree on the new devices.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree as _tree
from repro_torch.devices import DeviceLike, replica_devices, visible_devices
from repro_torch.distributed.runtime import DataMesh

__all__ = ["physical_data_world", "process_fold", "reshard",
           "mesh_from_available_devices", "replicate_spec_tree"]


def physical_data_world(logical: int,
                        n_devices: Optional[int] = None) -> int:
    """The data-mesh size a ``data_parallel=logical`` run uses here: the
    largest divisor of ``logical`` that fits the visible devices
    (default: the CUDA cards, or 1 without CUDA), so every device carries
    the same whole number of shard slots."""
    if logical < 1:
        raise ValueError(f"logical world must be >= 1, got {logical}")
    if n_devices is None:
        n_devices = (torch.cuda.device_count()
                     if torch.cuda.is_available() else 1)
    p = min(logical, max(int(n_devices), 1))
    while logical % p:
        p -= 1
    return p


def process_fold(logical: int, procs: int, local_devices: int, *,
                 elastic: bool = True) -> tuple:
    """The three-level fold of a gang: logical shard slots → one
    contiguous block a process → a fold a device.

    → ``(local_slots, d_local, physical)``: ``local_slots = logical //
    procs``, ``d_local`` the largest divisor of it that fits
    ``local_devices`` (with ``elastic=False`` the slots must map one to
    one onto local devices), ``physical = procs · d_local``."""
    if procs < 1:
        raise ValueError(f"procs must be >= 1, got {procs}")
    if logical % procs:
        raise ValueError(
            f"data_parallel={logical} logical shard slots cannot split "
            f"evenly over {procs} processes")
    local_slots = logical // procs
    if elastic:
        d_local = physical_data_world(local_slots, local_devices)
    else:
        if local_slots > local_devices:
            raise ValueError(
                f"{local_slots} shard slots per process need "
                f"{local_slots} local devices but only {local_devices} "
                "are visible — pass elastic=True to fold")
        d_local = local_slots
    return local_slots, d_local, procs * d_local


def reshard(tree: Any, devices: Any) -> Any:
    """``tree`` with every tensor leaf moved to its device: ``devices`` a
    single device for all, or a tree of devices matching ``tree``
    (``replicate_spec_tree``).  Non-tensor leaves stay as they are."""
    leaves = _tree.leaves(tree)
    if isinstance(devices, (str, torch.device)):
        targets = [devices] * len(leaves)
    else:
        targets = _tree.leaves(devices)
    return _tree.unflatten(tree, [
        x.to(d) if isinstance(x, torch.Tensor) else x
        for x, d in zip(leaves, targets)])


def mesh_from_available_devices(model_parallel: int = 1,
                                max_devices: Optional[int] = None,
                                device: DeviceLike = None) -> DataMesh:
    """A one-process data mesh over the devices that are alive from
    ``device`` on (at most ``max_devices``): data size = n //
    model_parallel."""
    n = visible_devices(device)
    if max_devices is not None:
        n = min(n, int(max_devices))
    if n % model_parallel:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel}")
    devs = tuple(replica_devices(device, n // model_parallel))
    return DataMesh(devices=devs,
                    placement=tuple((0, str(d)) for d in devs))


def replicate_spec_tree(tree: Any, mesh: DataMesh) -> Any:
    """A tree like ``tree`` naming, for every leaf, the device a
    replicated copy lives on (the mesh's first)."""
    return _tree.unflatten(tree, [mesh.devices[0]] * len(_tree.leaves(tree)))
