"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import List, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda:0``.  Raises when CUDA is absent and the
    caller did not ask for the CPU: the port never moves to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain torch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


def replica_devices(device: DeviceLike, replicas: int) -> List[torch.device]:
    """``replicas`` devices starting at ``device``: cuda:i..i+N-1 on the
    card, N handles to the same CPU otherwise."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    base = resolve_device(device)
    if base.type != "cuda":
        return [base] * replicas
    first = base.index
    if first + replicas > torch.cuda.device_count():
        raise ValueError(
            f"{replicas} replicas from cuda:{first} need "
            f"{first + replicas} devices, have {torch.cuda.device_count()}")
    return [torch.device("cuda", first + i) for i in range(replicas)]


def visible_devices(device: DeviceLike = None) -> int:
    """Devices a process can spread data-parallel slots over: the CUDA
    cards for a CUDA device, 1 for the CPU."""
    base = resolve_device(device)
    return torch.cuda.device_count() if base.type == "cuda" else 1
