"""Linear model over packed b-bit codes (counterpart of
``repro/models/linear.py``, serving forward).

The weight is a (k, 2^b, C) float32 table — the expanded 2^b·k weight
vector reshaped, the reference's layout — plus a (C,) bias, held in a
plain dict of tensors ``{"table", "bias"}``.  Binary problems keep one
output column (C = 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class BBitLinearConfig:
    k: int
    b: int
    n_classes: int = 2
    normalize: bool = False      # optional 1/sqrt(k) feature scaling

    @property
    def n_out(self) -> int:
        return 1 if self.n_classes == 2 else self.n_classes


def init_bbit_linear(cfg: BBitLinearConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> dict:
    """Zero table and bias, or a 0.01·N(0, 1) table drawn from
    ``generator`` (on the generator's device, then moved)."""
    dev = resolve_device(device)
    shape = (cfg.k, 1 << cfg.b, cfg.n_out)
    if generator is None:
        table = torch.zeros(shape, dtype=torch.float32, device=dev)
    else:
        table = 0.01 * torch.randn(shape, generator=generator,
                                   device=generator.device).to(dev)
    return {"table": table,
            "bias": torch.zeros((cfg.n_out,), dtype=torch.float32,
                                device=dev)}


def params_from_jax(params_np: Mapping[str, np.ndarray],
                    device: DeviceLike = None) -> dict:
    """The reference's params (numpy arrays: table (k, 2^b, n_out), bias
    (n_out,)) → the port's; the layout is the same, so this converts
    the array type only."""
    dev = resolve_device(device)
    return {name: torch.tensor(np.asarray(params_np[name], np.float32),
                               device=dev)
            for name in ("table", "bias")}


def bbit_logits_packed(params, packed: torch.Tensor, cfg: BBitLinearConfig,
                       empty_packed: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Packed uint8 (n, ceil(k·b/8)) rows → logits (n, n_out) float32.
    ``empty_packed`` (the ``oph_zero`` packbits mask) drops the marked
    bins."""
    out = ops.bbit_linear_packed(packed, params["table"], cfg.k, cfg.b,
                                 empty=empty_packed)
    if cfg.normalize:
        out = out / math.sqrt(cfg.k)
    return out + params["bias"].to(torch.float32)


def bbit_scores_packed(params, packed: torch.Tensor, cfg: BBitLinearConfig,
                       empty_packed: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Serving-shaped scores: binary → (n,) margin, multiclass → (n, C)."""
    logits = bbit_logits_packed(params, packed, cfg,
                                empty_packed=empty_packed)
    return logits[:, 0] if cfg.n_classes == 2 else logits
