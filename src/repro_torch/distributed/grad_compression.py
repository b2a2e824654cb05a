"""b-bit gradient compression with error feedback for the data-parallel
all-reduce (counterpart of ``repro/distributed/grad_compression.py``).

The paper compresses features to b bits; the same storage argument
applies to the gradient exchange of the data-parallel step:

    q_t   = Q_b(g_t + e_t)            blockwise absmax int8, or sign+scale
    e_t+1 = (g_t + e_t) - deQ(q_t)    local error memory
    ĝ_t   = (1/S) Σ_devices deQ(q_t)  int8 all_gather + a local sum

The quantizer is the reference's, bit for bit: blocks of ``block``
values (the tail zero-padded), ``scale = absmax / 127`` (1 for an
all-zero block), ``q = clip(round(x / scale), -127, 127)`` with
round-half-to-even.  The gathered payloads are dequantized and summed in
device order (rank, then the rank's local devices), then divided by the
number of devices.  The int8 path puts about a quarter of the float32
all-reduce's bytes on the wire; the sign path sends one int8 a value too
(as the reference does: its signs are not bit-packed), so it saves the
scales' bytes only.  The collectives record
(``distributed.collectives``) shows them.

Each function takes the gradients of this process's ``D`` local devices
stacked on a leading axis, and its error memory the same way; with one
process holding the whole world, ``D`` is that world.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.distributed.collectives import (all_gather_stacked,
                                                 group_size)

__all__ = ["compressed_allreduce_mean", "tree_compressed_allreduce_mean",
           "init_error_state"]


def _blockwise_quantize(g: torch.Tensor, block: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    absmax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    one = torch.ones((), dtype=blocks.dtype, device=blocks.device)
    scale = torch.where(absmax > 0, absmax / 127.0, one)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _blockwise_dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                          block: int) -> torch.Tensor:
    flat = (q.to(torch.float32).reshape(-1, block)
            * scale[:, None]).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return flat[:size].reshape(shape)


def _sign_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.sign(x).to(torch.int8), torch.mean(torch.abs(x))


def compressed_allreduce_mean(
    g: torch.Tensor,
    err: torch.Tensor,
    group=None,
    *,
    block: int = 256,
    bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 (``bits=8``) or sign (``bits=1``)
    all-reduce-mean.  ``g`` and ``err`` are (D, ...): this process's D
    local devices' gradients and residuals → (the mean over every
    device of the world, float32 (...); the new (D, ...) residuals)."""
    if bits not in (1, 8):
        raise ValueError("bits must be 1 or 8")
    d_local = g.shape[0]
    shape = tuple(g.shape[1:])
    corrected = g.to(torch.float32) + err
    qs, scales, new_err = [], [], []
    for d in range(d_local):
        c = corrected[d]
        if bits == 8:
            q, scale = _blockwise_quantize(c, block)
            deq = _blockwise_dequantize(q, scale, shape, block)
        else:
            q, scale = _sign_quantize(c)
            deq = q.to(torch.float32) * scale
        qs.append(q)
        scales.append(scale)
        new_err.append(c - deq)
    # int8 payload and the float32 scales on the wire: (S, D, ...) in
    # rank order, then the rank's devices
    q_all = all_gather_stacked(torch.stack(qs), group)
    s_all = all_gather_stacked(torch.stack(scales), group)
    q_all = q_all.reshape((-1,) + tuple(q_all.shape[2:]))
    s_all = s_all.reshape((-1,) + tuple(s_all.shape[2:]))
    total = None
    for s in range(q_all.shape[0]):
        if bits == 8:
            term = q_all[s].to(torch.float32) * s_all[s][:, None]
        else:
            term = q_all[s].to(torch.float32) * s_all[s]
        total = term if total is None else total + term
    n = torch.tensor(float(group_size(group) * d_local),
                     dtype=torch.float32, device=total.device)
    if bits == 8:
        size = 1
        for s in shape:
            size *= s
        mean = total.reshape(-1)[:size].reshape(shape) / n
    else:
        mean = total / n
    return mean, torch.stack(new_err)


def tree_compressed_allreduce_mean(grads: Any, errs: Any, group=None, *,
                                   block: int = 256, bits: int = 8):
    """``compressed_allreduce_mean`` over every leaf of ``grads`` (errs
    the same structure) → (mean tree, new error tree)."""
    flat_g = _tree.leaves(grads)
    flat_e = _tree.leaves(errs)
    out_g, out_e = [], []
    for g, e in zip(flat_g, flat_e):
        mg, ne = compressed_allreduce_mean(g, e, group, block=block,
                                           bits=bits)
        out_g.append(mg)
        out_e.append(ne)
    return _tree.unflatten(grads, out_g), _tree.unflatten(grads, out_e)


def init_error_state(params: Any, local: int = 1) -> Any:
    """Zero float32 error memory of every param leaf, one copy for each
    of ``local`` devices on a leading axis."""
    return _tree.unflatten(params, [
        torch.zeros((local,) + tuple(p.shape), dtype=torch.float32,
                    device=p.device) for p in _tree.leaves(params)])
