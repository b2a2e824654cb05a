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
``p·(1 - lr·wd)``).  Moments are float32, updated in place, or stored as
bfloat16 or row-wise int8 (``optim/quantized_state.py``): each step then
widens them to float32, updates and stores them again, as the reference
does.  A leaf of more than ``chunked_update_threshold`` elements (and at
least two dims) updates one slice of its leading axis at a time, so its
float32 moments never exist whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Union

import numpy as np
import torch

from repro_torch.optim.quantized_state import (QuantizedArray,
                                               maybe_dequantize,
                                               maybe_quantize)

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
    moment_dtype: str = "float32"  # 'float32' | 'bfloat16' | 'int8'
    quant_block: int = 256
    chunked_update_threshold: int = 1 << 28


def adamw(lr: LR, cfg: AdamWConfig = AdamWConfig()) -> Optimizer:
    in_place = cfg.moment_dtype == "float32"

    def init(params):
        # m and v are distinct buffers: the update writes both in place
        def mk():
            return {n: maybe_quantize(
                torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                cfg.moment_dtype, cfg.quant_block)
                for n, p in params.items()}
        return {"m": mk(), "v": mk()}

    def upd_core(p, g, m_q, v_q, lr_t, c1, c2):
        """Writes ``p``'s step in place → the new (m, v) storage."""
        g = g.to(torch.float32)
        if in_place:
            m = m_q.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v = v_q.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        else:
            m = cfg.b1 * maybe_dequantize(m_q) + (1 - cfg.b1) * g
            v = cfg.b2 * maybe_dequantize(v_q) + (1 - cfg.b2) * g * g
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.sub_(lr_t * delta)
        if in_place:
            return m, v
        return (maybe_quantize(m, cfg.moment_dtype, cfg.quant_block),
                maybe_quantize(v, cfg.moment_dtype, cfg.quant_block))

    def _slice(x, i):
        if isinstance(x, QuantizedArray):
            return QuantizedArray(q=x.q[i], scale=x.scale[i])
        return x[i]

    def _stack(parts):
        if isinstance(parts[0], QuantizedArray):
            return QuantizedArray(q=torch.stack([x.q for x in parts]),
                                  scale=torch.stack([x.scale for x in parts]))
        return torch.stack(parts)

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        t = step.to(torch.float32) + 1.0
        c1 = 1.0 - cfg.b1 ** t
        c2 = 1.0 - cfg.b2 ** t
        for name, p in params.items():
            g, m_q, v_q = grads[name], state["m"][name], state["v"][name]
            if p.numel() <= cfg.chunked_update_threshold or p.dim() < 2:
                m, v = upd_core(p, g, m_q, v_q, lr_t, c1, c2)
            else:
                # the leading (layer) axis one slice at a time
                parts = [upd_core(p[i], g[i], _slice(m_q, i),
                                  _slice(v_q, i), lr_t, c1, c2)
                         for i in range(p.shape[0])]
                m = m_q if in_place else _stack([x[0] for x in parts])
                v = v_q if in_place else _stack([x[1] for x in parts])
            state["m"][name], state["v"][name] = m, v
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
