"""The paper's LIBLINEAR experiments (counterpart of
``repro/train/linear_trainer.py``).

``train_bbit_liblinear`` — TRON on the exact Eq. (8)/(9) objective over
                           b-bit hashed codes (the paper's setup);
``train_vw_liblinear``   — the same solver over VW sketches (paper §5.4);
``train_bbit_sgd``       — in-memory minibatch SGD/AdamW over b-bit codes,
                           the baseline of the streaming trainer.

All run on ``device`` (default ``cuda:0``; ``"cpu"`` runs the kernels'
plain versions).  On the card the b-bit forward is kernel B7 and its
gradient B8, through ``kernels.ops.bbit_linear``.  B8 keeps a plan per
codes tensor: TRON reuses one for a whole fit, while every minibatch of
``train_bbit_sgd`` is a new tensor and builds its own plan
(``ops.counts()["bbit_linear_bwd_dw_plans"]``).

A TRON fit is traced (``obs``) by the spans ``trainer.fit`` (the whole
call: the table's start, the inputs, TRON, the sync, the accuracy pass)
and ``trainer.accuracy`` (the predictions and their accuracies); every
trainer here counts ``trainer.h2d_bytes`` (host inputs moved to a card)
and ``trainer.d2h_bytes`` (a card's predictions and labels copied to the
host for their accuracy), and TRON's Hessian products count
``trainer.curvature_builds`` (ℓ″ computed at an iterate) and
``trainer.curvature_hits`` (a product reusing it).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models.linear import (BBitLinearConfig, VWLinearConfig,
                                       bbit_logits, full_float32_matmul,
                                       init_bbit_linear,
                                       init_vw_linear, predict_classes,
                                       vw_logits, vw_predict)
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.tron import tron_minimize
from repro_torch.train.losses import (LOSS_D2, liblinear_objective,
                                      mean_loss_fn)
from repro_torch.train.metrics import accuracy
from repro_torch.train.steps import build_train_step, init_state

_H2D_BYTES = obs.counter("trainer.h2d_bytes")
_D2H_BYTES = obs.counter("trainer.d2h_bytes")
_CURVATURE_BUILDS = obs.counter("trainer.curvature_builds")
_CURVATURE_HITS = obs.counter("trainer.curvature_hits")
obs.declare("trainer.fit", "trainer.accuracy")


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def make_liblinear_hvp(forward, loss: str, C: float, codes: torch.Tensor,
                       labels: torch.Tensor):
    """Analytic Hv = v + C·Xᵀ(ℓ″(m)⊙Xv), m = y·Xw, for models linear in
    the params.

    ℓ″(m) depends on w alone, so it is computed at the first product at a
    params object and kept, with that object's tensors and their
    versions (``_version``): a product at the same tensors, unwritten,
    reuses it (``trainer.curvature_hits``); any other params, or the same
    tensors written in place, get it anew (``trainer.curvature_builds``).
    TRON hands every product at one iterate the same params object, so,
    as in LIBLINEAR (whose ``fun(w)`` keeps D = ℓ″ for ``Hv``), a product
    costs one forward (X·v) and one backward (Xᵀ·, through the graph of
    that forward), and an iterate one forward (X·w) more.  Both run
    through the kernels' autograd Functions (B7 and B8 on a card), with
    no forward-mode AD, and match LIBLINEAR's TRON Hessian exactly.  Xᵀ·
    is rounded to the params' dtype before it widens to float32, the
    bits of the backward through the params themselves.  The forward
    includes the bias, a feature of constant 1, as in the reference.
    """
    d2_fn = LOSS_D2[loss]
    y = 2.0 * labels.to(torch.float32) - 1.0
    kept_tensors, kept_versions, kept_d2 = (), (), None

    def curvature(params):
        """ℓ″(m) at ``params``, kept from the last call if it was there."""
        nonlocal kept_tensors, kept_versions, kept_d2
        tensors = tuple(params[name] for name in sorted(params))
        versions = tuple(t._version for t in tensors)
        if versions == kept_versions and all(
                a is b for a, b in zip(tensors, kept_tensors)):
            _CURVATURE_HITS.add()
            return kept_d2
        with torch.no_grad():
            d2 = d2_fn(y * forward(params, codes)[:, 0])
        _CURVATURE_BUILDS.add()
        kept_tensors, kept_versions, kept_d2 = tensors, versions, d2
        return d2

    def hvp(params, v):
        d2 = curvature(params)
        names = sorted(v)
        vs = {name: v[name].detach().requires_grad_(True) for name in names}
        with torch.enable_grad():
            jv = forward(vs, codes)             # J·v: the forward is linear
        hv_logits = (C * d2 * jv.detach()[:, 0])[:, None]
        hv = torch.autograd.grad(jv, [vs[name] for name in names], hv_logits)
        return {name: v[name].to(torch.float32)
                + h.to(params[name].dtype).to(torch.float32)
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
    """A numpy array or tensor as a contiguous ``dtype`` tensor on dev; a
    host input's bytes on a card count in ``trainer.h2d_bytes``."""
    if isinstance(x, torch.Tensor):
        out = x.to(device=dev, dtype=dtype).contiguous()
        host = x.device.type == "cpu"
    else:
        out = torch.tensor(np.asarray(x, dtype=_NUMPY_TYPE[dtype]),
                           device=dev)
        host = True
    if host and dev.type != "cpu":
        _H2D_BYTES.add(_nbytes(out))
    return out


def _accuracy(pred, labels) -> float:
    """``accuracy``, which copies its tensors to the host: the bytes of
    those on a card count in ``trainer.d2h_bytes``."""
    _D2H_BYTES.add(sum(_nbytes(x) for x in (pred, labels)
                       if isinstance(x, torch.Tensor)
                       and x.device.type != "cpu"))
    return accuracy(pred, labels)


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
    with torch.no_grad(), obs.span("trainer.accuracy"):
        tr_acc = _accuracy(predict(res.params, x_tr), y_tr)
        te_acc = _accuracy(predict(res.params, x_te), y_te)
    return FitResult(res.params, dt, tr_acc, te_acc, res.n_iter, res.fun)


def train_bbit_liblinear(codes_tr, y_tr, codes_te, y_te,
                         cfg: BBitLinearConfig, *, loss: str = "logistic",
                         C: float = 1.0, max_iter: int = 60,
                         device: DeviceLike = None) -> FitResult:
    """TRON over integer codes (n, k) (numpy or tensors), labels in
    {0, 1}; ``loss`` 'logistic' (Eq. 9) or 'squared_hinge' (Eq. 8)."""
    with obs.span("trainer.fit"):
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
    with obs.span("trainer.fit"), full_float32_matmul():
        dev = resolve_device(device)
        return _fit(lambda p, x: vw_logits(p, x, cfg),
                    lambda p, x: vw_predict(p, x, cfg),
                    init_vw_linear(cfg, device=dev),
                    _on(sk_tr, dev, torch.float32), y_tr,
                    _on(sk_te, dev, torch.float32), y_te,
                    loss=loss, C=C, max_iter=max_iter, dev=dev)


def _initial_params(cfg: BBitLinearConfig, seed: int,
                    device: DeviceLike) -> dict:
    """The start of an SGD fit (``train_bbit_sgd``, ``train.streaming``):
    a 0.01·N(0, 1) table drawn from a CPU generator seeded with ``seed``,
    then moved, so the card and the CPU start equal; a zero bias.  The
    reference draws from ``jax.random.key(seed)``, which torch cannot
    reproduce; its parity tests replace this function by the reference's
    start."""
    return init_bbit_linear(cfg, torch.Generator().manual_seed(seed),
                            device=device)


def train_bbit_sgd(codes_tr, y_tr, codes_te, y_te, cfg: BBitLinearConfig,
                   *, loss: str = "logistic", optimizer: str = "adamw",
                   lr: float = 1e-2, l2: float = 1e-6, epochs: int = 5,
                   batch_size: int = 256, seed: int = 0,
                   device: DeviceLike = None) -> FitResult:
    """Minibatch SGD/AdamW over integer codes (n, k) held in memory, the
    reference's permutation of rows each epoch (``default_rng(seed)``);
    a shorter last minibatch trains too.  ``n_iter`` is the step count,
    ``objective`` NaN."""
    n = codes_tr.shape[0]
    if n < 1:
        raise ValueError("train_bbit_sgd: empty training set")
    if epochs < 1:
        raise ValueError(f"train_bbit_sgd: epochs must be >= 1, got {epochs}")
    dev = resolve_device(device)
    loss_fn = mean_loss_fn(lambda p, c: bbit_logits(p, c, cfg), loss, l2=l2)
    opt = make_optimizer(optimizer, lr)
    state = init_state(_initial_params(cfg, seed, dev), opt)
    step_fn = build_train_step(loss_fn, opt)
    x_tr = _on(codes_tr, dev, torch.int32)
    y_tr_t = _on(y_tr, dev, torch.int32)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    steps = 0
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        for lo in range(0, n, batch_size):
            sel = order[lo: lo + batch_size]
            state, _ = step_fn(state, x_tr[sel], y_tr_t[sel])
            steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    with torch.no_grad():
        tr_acc = _accuracy(predict_classes(state.params, x_tr, cfg), y_tr)
        te_acc = _accuracy(predict_classes(
            state.params, _on(codes_te, dev, torch.int32), cfg), y_te)
    return FitResult(state.params, dt, tr_acc, te_acc, steps, float("nan"))
