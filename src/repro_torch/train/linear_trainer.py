"""The paper's LIBLINEAR experiments (counterpart of
``repro/train/linear_trainer.py``).

``train_bbit_liblinear`` — TRON on the exact Eq. (8)/(9) objective over
                           b-bit hashed codes (the paper's setup);
``train_vw_liblinear``   — the same solver over VW sketches (paper §5.4).

Both run on ``device`` (default ``cuda:0``; ``"cpu"`` runs the kernels'
plain versions).  On the card the b-bit forward is kernel B7 and its
gradient B8, through ``kernels.ops.bbit_linear``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models.linear import (BBitLinearConfig, VWLinearConfig,
                                       bbit_logits, full_float32_matmul,
                                       init_bbit_linear,
                                       init_vw_linear, predict_classes,
                                       vw_logits, vw_predict)
from repro_torch.optim.tron import tron_minimize
from repro_torch.train.losses import LOSS_D2, liblinear_objective
from repro_torch.train.metrics import accuracy


def make_liblinear_hvp(forward, loss: str, C: float, codes: torch.Tensor,
                       labels: torch.Tensor):
    """Analytic Hv = v + C·Xᵀ(ℓ″(m)⊙Xv) for models linear in the params.

    Uses only forward passes and one backward (Xᵀ·), no forward-mode
    AD, so it runs through the kernels' autograd Functions, and matches
    LIBLINEAR's TRON Hessian exactly.  The forward includes the bias, a
    feature of constant 1, as in the reference.
    """
    d2_fn = LOSS_D2[loss]
    y = 2.0 * labels.to(torch.float32) - 1.0

    def hvp(params, v):
        names = sorted(params)
        p = {name: params[name].detach().requires_grad_(True)
             for name in names}
        with torch.enable_grad():
            logits = forward(p, codes)
        with torch.no_grad():
            d2 = d2_fn(y * logits[:, 0])
            jv = forward(v, codes)[:, 0]        # J·v: the forward is linear
            hv_logits = (C * d2 * jv)[:, None]
        hv = torch.autograd.grad(logits, [p[name] for name in names],
                                 hv_logits)
        return {name: v[name].to(torch.float32) + h.to(torch.float32)
                for name, h in zip(names, hv)}

    return hvp


@dataclasses.dataclass
class FitResult:
    params: dict
    train_seconds: float
    train_acc: float
    test_acc: float
    n_iter: int
    objective: float


_NUMPY_TYPE = {torch.int32: np.int32, torch.float32: np.float32}


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array or tensor as a contiguous ``dtype`` tensor on dev."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    return torch.tensor(np.asarray(x, dtype=_NUMPY_TYPE[dtype]), device=dev)


def _fit(forward, predict, w0, x_tr, y_tr, x_te, y_te, *, loss, C,
         max_iter, dev) -> FitResult:
    obj = liblinear_objective(forward, loss, C)
    y_tr_t = _on(y_tr, dev, torch.int32)
    hvp = make_liblinear_hvp(forward, loss, C, x_tr, y_tr_t)
    t0 = time.perf_counter()
    res = tron_minimize(lambda p: obj(p, x_tr, y_tr_t), w0, hvp=hvp,
                        max_iter=max_iter)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    with torch.no_grad():
        tr_acc = accuracy(predict(res.params, x_tr), y_tr)
        te_acc = accuracy(predict(res.params, x_te), y_te)
    return FitResult(res.params, dt, tr_acc, te_acc, res.n_iter, res.fun)


def train_bbit_liblinear(codes_tr, y_tr, codes_te, y_te,
                         cfg: BBitLinearConfig, *, loss: str = "logistic",
                         C: float = 1.0, max_iter: int = 60,
                         device: DeviceLike = None) -> FitResult:
    """TRON over integer codes (n, k) (numpy or tensors), labels in
    {0, 1}; ``loss`` 'logistic' (Eq. 9) or 'squared_hinge' (Eq. 8)."""
    dev = resolve_device(device)
    return _fit(lambda p, c: bbit_logits(p, c, cfg),
                lambda p, c: predict_classes(p, c, cfg),
                init_bbit_linear(cfg, device=dev),
                _on(codes_tr, dev, torch.int32), y_tr,
                _on(codes_te, dev, torch.int32), y_te,
                loss=loss, C=C, max_iter=max_iter, dev=dev)


def train_vw_liblinear(sk_tr, y_tr, sk_te, y_te, cfg: VWLinearConfig, *,
                       loss: str = "logistic", C: float = 1.0,
                       max_iter: int = 60,
                       device: DeviceLike = None) -> FitResult:
    """TRON over dense VW sketches (n, m) (numpy or tensors), with TF32
    off (``full_float32_matmul``) for the whole fit, so the gradient's
    and the Hessian products' matmuls run in full float32 too."""
    dev = resolve_device(device)
    with full_float32_matmul():
        return _fit(lambda p, x: vw_logits(p, x, cfg),
                    lambda p, x: vw_predict(p, x, cfg),
                    init_vw_linear(cfg, device=dev),
                    _on(sk_tr, dev, torch.float32), y_tr,
                    _on(sk_te, dev, torch.float32), y_te,
                    loss=loss, C=C, max_iter=max_iter, dev=dev)
