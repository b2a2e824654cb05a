"""Train steps (counterpart of ``repro/train/steps.py``).

``build_train_step`` is the plain SGD/AdamW step; ``build_averaged_
train_step`` adds Polyak tail averaging (``optim.averaging``) through an
``AveragedTrainState``, the state the streaming trainer checkpoints, so
a resumed run continues the running mean bit for bit;
``build_microbatched_train_step`` accumulates the LM zoo's gradients
over microbatches.  A step is a plain function: autograd for the
gradient, then the optimizer's and the average's in-place updates under
``torch.no_grad()``.  It reads nothing back to the host, so steps on the
card queue behind each other.  Params are a flat dict of tensors, or
(the plain and microbatched steps) the LM zoo's nested one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.optim.averaging import init_average, polyak_update
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import leaves, paths, tree_map, unflatten

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: Any
    step: torch.Tensor           # int32 0-d, on the params' device


def _flat(params) -> Params:
    """The params as the optimizers' flat dict, keyed by the leaves'
    paths (a flat dict's own keys; 'layers/wq' in the LM zoo's tree)."""
    return dict(zip(paths(params), leaves(params)))


def init_state(params, optimizer: Optimizer) -> TrainState:
    """The step-0 state; ``params`` a flat dict of tensors or a nested
    one (the optimizer's state is then keyed by the leaves' paths)."""
    dev = leaves(params)[0].device
    return TrainState(params=params, opt_state=optimizer.init(_flat(params)),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _value_and_grad(loss_fn: Callable, params, batch: tuple,
                    has_aux: bool):
    """(loss_fn's output, detached; the gradient of its loss in every
    param, keyed as ``_flat(params)``) at ``params``."""
    names = paths(params)
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        out = loss_fn(unflatten(params, live), *batch)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, live)
    if has_aux:
        out = (out[0].detach(), out[1])
    else:
        out = out.detach()
    return out, dict(zip(names, grads))


def _update(optimizer: Optimizer, grads: Params, state: TrainState):
    new_flat, new_opt = optimizer.update(grads, state.opt_state,
                                         _flat(state.params), state.step)
    new_params = unflatten(state.params,
                           [new_flat[n] for n in paths(state.params)])
    return TrainState(new_params, new_opt, state.step + 1)


def build_train_step(loss_fn: Callable, optimizer: Optimizer):
    """``loss_fn(params, *batch) -> scalar``; returns
    ``step(state, *batch) -> (state, loss)``."""

    def step(state: TrainState, *batch):
        loss, grads = _value_and_grad(loss_fn, state.params, batch, False)
        return _update(optimizer, grads, state), loss

    return step


def build_microbatched_train_step(loss_fn: Callable, optimizer: Optimizer,
                                  n_micro: int):
    """Gradient accumulation over ``n_micro`` microbatches: every batch
    leaf (tensors, or dicts of them) splits along its leading dim, which
    ``n_micro`` must divide; the gradients of the slices are summed in
    float32 in order, the mean taken, then one optimizer update.  Only
    one microbatch's activations live at a time.  Returns ``step(state,
    *batch) -> (state, mean loss)``."""

    def step(state: TrainState, *batch):
        def split(x):
            return x.reshape((n_micro, x.shape[0] // n_micro)
                             + tuple(x.shape[1:]))

        micro = tree_map(split, batch)
        gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
                for n, p in _flat(state.params).items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
        for i in range(n_micro):
            mb = tree_map(lambda x: x[i], micro)
            loss, g = _value_and_grad(loss_fn, state.params, mb, False)
            gsum = {n: gsum[n] + g[n] for n in gsum}
            loss_sum = loss_sum + loss
        grads = {n: g / n_micro for n, g in gsum.items()}
        return _update(optimizer, grads, state), loss_sum / n_micro

    return step


@dataclasses.dataclass
class AveragedTrainState:
    """``TrainState`` plus the Polyak running mean of the params:
    ``avg_params`` the float32 mean over the steps where the averaging
    gate was active, ``avg_count`` their number."""
    state: TrainState
    avg_params: Params
    avg_count: torch.Tensor


def init_averaged_state(params: Params,
                        optimizer: Optimizer) -> AveragedTrainState:
    avg, count = init_average(params)
    return AveragedTrainState(state=init_state(params, optimizer),
                              avg_params=avg, avg_count=count)


def build_averaged_train_step(loss_fn: Callable, optimizer: Optimizer,
                              has_aux: bool = False):
    """``loss_fn(params, *batch) -> scalar`` (or ``(scalar, aux)`` with
    ``has_aux``); returns ``step(astate, active, *batch) -> (astate,
    loss | (loss, aux))``.  ``active`` (0/1) gates whether the
    post-update params join the Polyak average; ``aux`` comes from the
    same forward as the gradient, before the update."""

    def step(astate: AveragedTrainState, active, *batch):
        out, grads = _value_and_grad(loss_fn, astate.state.params, batch,
                                     has_aux)
        new_params, new_opt = optimizer.update(
            grads, astate.state.opt_state, astate.state.params,
            astate.state.step)
        avg, count = polyak_update(astate.avg_params, astate.avg_count,
                                   new_params, active)
        new_state = TrainState(new_params, new_opt, astate.state.step + 1)
        return AveragedTrainState(new_state, avg, count), out

    return step
