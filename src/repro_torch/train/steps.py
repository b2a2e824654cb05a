"""Train steps (counterpart of ``repro/train/steps.py``).

``build_train_step`` is the plain SGD/AdamW step; ``build_averaged_
train_step`` adds Polyak tail averaging (``optim.averaging``) through an
``AveragedTrainState``, the state the streaming trainer checkpoints, so
a resumed run continues the running mean bit for bit.  A step is a
plain function: autograd for the gradient, then the optimizer's and the
average's in-place updates under ``torch.no_grad()``.  It reads nothing
back to the host, so steps on the card queue behind each other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.optim.averaging import init_average, polyak_update
from repro_torch.optim.optimizers import Optimizer

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: Any
    step: torch.Tensor           # int32 0-d, on the params' device


def init_state(params: Params, optimizer: Optimizer) -> TrainState:
    dev = next(iter(params.values())).device
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _value_and_grad(loss_fn: Callable, params: Params, batch: tuple,
                    has_aux: bool):
    """(loss_fn's output, detached; the gradient of its loss in every
    param) at ``params``."""
    names = sorted(params)
    live = {n: params[n].detach().requires_grad_(True) for n in names}
    with torch.enable_grad():
        out = loss_fn(live, *batch)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, [live[n] for n in names])
    if has_aux:
        out = (out[0].detach(), out[1])
    else:
        out = out.detach()
    return out, dict(zip(names, grads))


def build_train_step(loss_fn: Callable, optimizer: Optimizer):
    """``loss_fn(params, *batch) -> scalar``; returns
    ``step(state, *batch) -> (state, loss)``."""

    def step(state: TrainState, *batch):
        loss, grads = _value_and_grad(loss_fn, state.params, batch, False)
        new_params, new_opt = optimizer.update(
            grads, state.opt_state, state.params, state.step)
        return TrainState(new_params, new_opt, state.step + 1), loss

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
