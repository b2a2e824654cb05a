"""int8 and bfloat16 storage of optimizer moments (counterpart of
``repro/optim/quantized_state.py``).

Moments use row-wise absmax int8: ``q`` keeps the parameter's shape
(int8) and ``scale`` collapses its last dim to 1 (float32), so payload
and scales split along the same rows as the parameter.  The arithmetic
is the reference's, in float32: ``scale = absmax / 127`` (1 where the
row is all zeros), ``q = clip(round(x / scale), -127, 127)`` with
round-half-to-even (``torch.round``, like ``jnp.round``), so the same
float32 inputs give the same bytes.

``QuantizedArray`` is a dataclass of ``(q, scale)``: ``repro_torch.tree``
flattens it in that order, as the reference's pytree node does, so a
checkpoint of int8 moments reads in either package.

The reference's ``moment_pspec`` (a ``PartitionSpec`` helper) belongs
with the sharding rules of the LM zoo (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

__all__ = ["QuantizedArray", "quantize", "dequantize", "maybe_quantize",
           "maybe_dequantize"]


@dataclasses.dataclass
class QuantizedArray:
    """int8 payload (the source's shape) and float32 row scales (its
    shape with the last dim 1; a 0-d source keeps a 0-d scale)."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return torch.int8


def _quantize_rows(xf: torch.Tensor):
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    one = torch.ones((), dtype=torch.float32, device=xf.device)
    scale = torch.where(absmax > 0, absmax / 127.0, one)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize(x: torch.Tensor) -> QuantizedArray:
    xf = x.to(torch.float32)
    if xf.dim() == 0:
        q, scale = _quantize_rows(xf[None])
        return QuantizedArray(q=q[0], scale=scale[0])
    q, scale = _quantize_rows(xf)
    return QuantizedArray(q=q, scale=scale)


def dequantize(qa: QuantizedArray) -> torch.Tensor:
    return qa.q.to(torch.float32) * qa.scale


def maybe_quantize(x: torch.Tensor, dtype: str, block: int = 0
                   ) -> Union[torch.Tensor, QuantizedArray]:
    """'float32' | 'bfloat16' | 'int8' storage of a moment tensor
    (``block`` is accepted and unused, as in the reference)."""
    del block
    if dtype == "int8":
        return quantize(x)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.to(torch.float32)


def maybe_dequantize(x) -> torch.Tensor:
    if isinstance(x, QuantizedArray):
        return dequantize(x)
    return x.to(torch.float32)
