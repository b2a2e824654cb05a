"""SGD (momentum, Nesterov) and AdamW over dicts of tensors (counterpart
of ``repro/optim/optimizers.py``).

``Optimizer`` is an (init, update) pair; ``update(grads, state, params,
step) -> (params, state)`` writes the params and the state in place,
under ``torch.no_grad()``, and returns them.  The formulas are the
reference's, in its order of float32 operations: AdamW's bias
corrections ``1 - b1**t`` and ``1 - b2**t`` are float32 tensors from
``t = step + 1``, eps is added to sqrt(v̂), and the weight decay is
added to the step, ``p - lr·(m̂/(sqrt(v̂)+eps) + wd·p)``.  That is not
``torch.optim.AdamW`` (which adds eps to sqrt(v)/sqrt(c2) and decays by
``p·(1 - lr·wd)``).  Moments are float32; the reference's bfloat16 and
int8 moments (``optim/quantized_state.py``) wait for ROADMAP A5.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]
LR = Union[float, Schedule]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params, torch.Tensor], tuple]
    # update(grads, state, params, step) -> (new_params, new_state)


def _lr_at(lr: LR, step: torch.Tensor):
    """The step's rate: a schedule's float32 tensor, or the float32
    value of a constant as a Python number."""
    return lr(step) if callable(lr) else float(np.float32(lr))


def sgd(lr: LR, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return {name: torch.zeros_like(p) for name, p in params.items()}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        if momentum == 0.0:
            for name, p in params.items():
                p.sub_(lr_t * grads[name])
            return params, ()
        for name, p in params.items():
            vel = state[name].mul_(momentum).add_(grads[name])
            upd = momentum * vel + grads[name] if nesterov else vel
            p.sub_(lr_t * upd)
        return params, state

    return Optimizer(init, update)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: str = "float32"


def adamw(lr: LR, cfg: AdamWConfig = AdamWConfig()) -> Optimizer:
    if cfg.moment_dtype != "float32":
        raise ValueError(
            f"moment_dtype={cfg.moment_dtype!r}: the port keeps float32 "
            "moments; bfloat16 and int8 moments wait for ROADMAP A5 "
            "(optim/quantized_state.py)")

    def init(params):
        # m and v are distinct buffers: the update writes both in place
        return {"m": {n: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for n, p in params.items()},
                "v": {n: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for n, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        t = step.to(torch.float32) + 1.0
        c1 = 1.0 - cfg.b1 ** t
        c2 = 1.0 - cfg.b2 ** t
        for name, p in params.items():
            g = grads[name].to(torch.float32)
            m = state["m"][name].mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v = state["v"][name].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.sub_(lr_t * delta)
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr: LR, *, weight_decay: float = 0.0,
                   momentum: float = 0.9,
                   moment_dtype: str = "float32") -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return sgd(lr, momentum=momentum)
    if name == "adamw":
        return adamw(lr, AdamWConfig(weight_decay=weight_decay,
                                     moment_dtype=moment_dtype))
    raise ValueError(f"unknown optimizer {name!r}")
