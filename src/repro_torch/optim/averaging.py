"""Polyak(-Ruppert) tail averaging of the SGD iterate (counterpart of
``repro/optim/averaging.py``).

The update is the reference's running mean, in float32, in place:

    count' = count + active
    avg'   = avg + active · (params − avg) / max(count', 1)

so ``active`` ∈ {0, 1} gates averaging: with 0, avg and count stay as
they are, and the first active step makes avg = params exactly.
``active`` is a Python number, so a step on the card queues no copy
from the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def init_average(params: Params) -> Tuple[Params, torch.Tensor]:
    """→ (zeros-like float32 average, count 0.0), the state pair
    ``polyak_update`` threads, on the params' device."""
    avg = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for name, p in params.items()}
    dev = next(iter(params.values())).device
    return avg, torch.zeros((), dtype=torch.float32, device=dev)


@torch.no_grad()
def polyak_update(avg: Params, count: torch.Tensor, params: Params,
                  active) -> Tuple[Params, torch.Tensor]:
    """One running-mean step, in place; ``active`` (0/1 or bool) gates
    whether this iterate joins the average."""
    a = float(active)
    count.add_(a)
    denom = torch.clamp(count, min=1.0)
    for name, m in avg.items():
        m.add_(a * (params[name].to(torch.float32) - m) / denom)
    return avg, count


def average_or_none(avg: Params, count: torch.Tensor) -> Optional[Params]:
    """The average if any step was averaged, else ``None``."""
    return avg if float(count) > 0 else None
