"""Data and replica meshes (counterpart of ``repro/launch/mesh.py``'s
one-dimensional meshes).

Functions, not module-level constants: importing this module touches no
device.  The reference's production and test meshes serve only its
dry-run of the LM zoo (ROADMAP A6).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.devices import DeviceLike, replica_devices, visible_devices
from repro_torch.distributed.runtime import DataMesh


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
