"""The data-parallel averaged train step (counterpart of
``repro/train/data_parallel.py``).

Each device of the data world (``distributed.runtime.DataMesh``: this
process's devices, and the ranks of its group) trains on its own shard
of the epoch — batches arrive stacked ``(slots, B, …)`` from
``data.prefetch.group_batch_stream`` — while the params stay replicated:

  * each shard slot runs autograd over the masked per-example SUM loss
    of its valid rows (``train.losses.sum_loss_with_hits_fn``: the
    packed forward B5 and its dW B6 on the card); padding rows carry
    dout 0.  Loss, hits, rows and gradient accumulate in slot order;
  * **elastic folding** (``logical_world > physical``): the batch keeps
    its logical slots; each device loops over its ``fold = logical /
    physical`` slots one after the other, so the schedule, and the
    replayed steps, depend on the logical world only;
  * then exactly two collectives (``distributed.collectives``): the
    stacked (loss, hits, rows) triple summed over the world, and the
    gradient through ``psum_mean`` (one fused all-reduce).  Without a
    group both are the identity;
  * the gradient is scaled after the reduction: ``psum_mean`` (÷
    physical), then × ``physical / total``, cast to the leaf's dtype.
    For power-of-two worlds both are exact rescalings of the same sum,
    so a two-slot schedule gives the same bits on one device folding two
    slots and on two ranks of one slot each (a + b is commutative).  A
    sum of four slots is not associative, so wider worlds agree only
    within their own topology;
  * the L2 term is added after the collectives, then AdamW (or SGD) and
    ``polyak_update`` run exactly as in the serial step: replicated
    params stay replicated without a broadcast.

``compress`` (``{"bits": 8 | 1, "block": 256}``) swaps the exact
gradient exchange for the error-feedback compressed one
(``distributed.grad_compression``); the carry then is ``(astate,
err)``, ``err`` each local device's residual (``init_dp_error_state``),
which is not checkpointed, as in the reference.

A process with several local devices keeps its state on the first; the
others get a copy of the params for their slots, and their sums come
back to the first in device order.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.data.hashed_dataset import _to_device
from repro_torch.distributed.collectives import psum, psum_mean
from repro_torch.distributed.grad_compression import (
    init_error_state, tree_compressed_allreduce_mean)
from repro_torch.distributed.runtime import DataMesh
from repro_torch.optim.averaging import polyak_update
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.losses import l2_sum
from repro_torch.train.steps import AveragedTrainState, TrainState

__all__ = ["init_dp_error_state", "device_put_sharded",
           "build_dp_averaged_train_step"]


def init_dp_error_state(params, physical: int):
    """Zero error-feedback memory of the compressed all-reduce: one
    float32 copy of every param leaf for each of this process's
    ``physical`` data devices, stacked on a leading axis (each device
    keeps its own quantization residual)."""
    return init_error_state(params, physical)


def device_put_sharded(x: np.ndarray, mesh: DataMesh) -> torch.Tensor:
    """This process's stacked ``(slots, …)`` host block on its first
    device (from pinned memory on a card); the step hands each local
    device its rows."""
    return _to_device(np.ascontiguousarray(x), mesh.devices[0])


def _slot(x, f: int, dev: torch.device):
    """Slot ``f``'s rows of a stacked block (or of each member of a
    codes-and-mask tuple) on ``dev``."""
    if isinstance(x, tuple):
        return tuple(t[f].to(dev) for t in x)
    return x[f].to(dev)


def build_dp_averaged_train_step(
    loss_sum_fn: Callable,
    optimizer: Optimizer,
    mesh: DataMesh,
    *,
    l2: float = 0.0,
    logical_world: Optional[int] = None,
    compress: Optional[dict] = None,
):
    """``loss_sum_fn(params, batch, labels, valid) -> (loss_sum, hits)``
    (masked sums over one slot's rows) → ``step(carry, active, batch,
    labels, valid) -> (carry, (mean_loss, hits))``.

    ``batch`` (a tensor, or a tuple of codes and mask), ``labels`` and
    ``valid`` are this process's ``(slots, B, …)`` block on its first
    device; ``carry`` is the ``AveragedTrainState`` (with ``compress``,
    ``(astate, err)``); ``mean_loss`` is the global mean over valid rows
    plus the L2 term, ``hits`` the global count of correct predictions.
    ``logical_world`` (default: the mesh's physical world) may exceed it
    by an integer factor: each device then folds ``logical / physical``
    slots.  The state is updated in place.
    """
    physical = mesh.physical
    logical = physical if logical_world is None else int(logical_world)
    if logical % physical:
        raise ValueError(
            f"logical world {logical} is not a multiple of the mesh's "
            f"{physical} data-axis devices — shard slots cannot fold "
            "evenly")
    fold = logical // physical
    if compress is not None:
        block = int(compress.get("block", 256))
        bits = int(compress.get("bits", 8))

    def slot(params: Dict[str, torch.Tensor], batch, labels, valid):
        names = sorted(params)
        live = {n: params[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            lsum, hits = loss_sum_fn(live, batch, labels, valid)
            grads = torch.autograd.grad(lsum, [live[n] for n in names])
        return (lsum.detach(), hits.to(torch.float32),
                torch.sum(valid.to(torch.float32)), dict(zip(names, grads)))

    def device_sums(params, batch, labels, valid, d: int):
        """Device ``d``'s sums over its ``fold`` slots, in slot order,
        on the state's device."""
        home = mesh.devices[0]
        dev = mesh.devices[d]
        if dev != home:
            params = {n: p.detach().to(dev) for n, p in params.items()}
        out = None
        for f in range(d * fold, (d + 1) * fold):
            part = slot(params, _slot(batch, f, dev), _slot(labels, f, dev),
                        _slot(valid, f, dev))
            if out is None:
                out = list(part)
            else:
                out[0] = out[0] + part[0]
                out[1] = out[1] + part[1]
                out[2] = out[2] + part[2]
                out[3] = {n: out[3][n] + part[3][n] for n in out[3]}
        lsum, hits_f, rows, gsum = out
        if dev != home:
            lsum, hits_f, rows = (x.to(home) for x in (lsum, hits_f, rows))
            gsum = {n: g.to(home) for n, g in gsum.items()}
        return lsum, hits_f, rows, gsum

    def accumulate(params, batch, labels, valid):
        """→ (stacked (loss, hits, rows) of this process, each device's
        gradient sum in device order)."""
        per_dev = [device_sums(params, batch, labels, valid, d)
                   for d in range(mesh.local)]
        lsum, hits_f, rows, _ = per_dev[0]
        for l_d, h_d, r_d, _ in per_dev[1:]:
            lsum, hits_f, rows = lsum + l_d, hits_f + h_d, rows + r_d
        return torch.stack([lsum, hits_f, rows]), [p[3] for p in per_dev]

    def scaled(grads, total):
        scale = torch.tensor(physical, dtype=torch.float32,
                             device=total.device) / total
        return {n: g * scale.to(g.dtype) for n, g in grads.items()}

    def apply(astate: AveragedTrainState, active, grads, lsum_g, hits_g,
              total):
        params = astate.state.params
        mean_loss = lsum_g / total
        if l2:
            # replicated params: the same term on every device, added
            # after the collectives so it counts once
            grads = {n: g + (l2 * params[n].to(torch.float32)).to(g.dtype)
                     for n, g in grads.items()}
            mean_loss = mean_loss + 0.5 * l2 * l2_sum(params)
        hits = hits_g.to(torch.int32)
        new_params, new_opt = optimizer.update(
            grads, astate.state.opt_state, params, astate.state.step)
        avg, count = polyak_update(astate.avg_params, astate.avg_count,
                                   new_params, active)
        new_state = TrainState(new_params, new_opt, astate.state.step + 1)
        return AveragedTrainState(new_state, avg, count), mean_loss, hits

    def step(carry, active, batch, labels, valid):
        astate = carry[0] if compress is not None else carry
        scalars, gsums = accumulate(astate.state.params, batch, labels,
                                    valid)
        # exactly two collectives a step: the scalar triple, then the
        # whole gradient fused
        lsum_g, hits_g, total = psum(scalars, mesh.group).unbind()
        if compress is None:
            gsum = gsums[0]
            for g_d in gsums[1:]:
                gsum = {n: gsum[n] + g_d[n] for n in gsum}
            grads = psum_mean(gsum, mesh.group, count=physical)
        else:
            # the gradient crosses quantized: the mean of the dequantized
            # device sums, scaled like the exact path; residuals stay here
            stacked = {n: torch.stack([g_d[n] for g_d in gsums])
                       for n in gsums[0]}
            grads, new_err = tree_compressed_allreduce_mean(
                stacked, carry[1], mesh.group, block=block, bits=bits)
        astate, mean_loss, hits = apply(astate, active,
                                        scaled(grads, total), lsum_g,
                                        hits_g, total)
        if compress is None:
            return astate, (mean_loss, hits)
        return (astate, new_err), (mean_loss, hits)

    return step
