"""TRON: trust-region Newton-CG, LIBLINEAR's primal solver (counterpart
of ``repro/optim/tron.py``).

Steihaug conjugate-gradient inner solves on one flat tensor, on the
params' device.  The params are flattened as the reference's
``ravel_pytree`` flattens them (sorted keys: ``bias`` before ``table``;
leaves of one dtype give a vector of that dtype), so the two solvers walk
like vectors, in the same dtypes: from a bfloat16 start the first
gradient and the first CG direction are bfloat16, and the arithmetic
that meets a float32 Hessian product or scalar widens to float32 as jnp
promotes (``_wide``), so the iterate is float32 after the first accepted
step, as the reference's is.  The scalar tests of the outer and
inner loops run on the host, as in the reference: each is one read of a
0-d tensor (``_read``, a sync on a card), counted in ``tron.host_reads``
and timed as the span ``tron.read`` (``obs``): one before the first
iteration, one at each test of the CG residual, one or two in a CG step,
five in an outer iteration besides its CG solve (one in the last, which
stops), and two at the end.  Unlike the reference's, the result keeps no
objective a step (no ``trace``), so an accepted step costs no read.
Hessian-vector products come from the caller (``hvp``, the analytic
Hv = v + C·Xᵀ(ℓ″(m)⊙Xv) of a linear model) or else from double backward.
Each iterate is unravelled once, and every ``hvp`` call at it (each CG
step of its solve and the sHs product) gets that one params object, so
an ``hvp`` may keep what depends on the iterate alone: the linear
trainers' keeps ℓ″(m), and a Hessian product there is one forward
product (X·v) and one transposed (Xᵀ·), plus one forward (X·w) an
iterate.  A CG step (one Hessian product) counts in
``tron.cg_steps``; the spans ``tron.minimize``, ``tron.iter`` and
``tron.cg_step`` time the call, an outer iteration and a CG step.

Hyper-parameters follow LIBLINEAR's tron.cpp: eta0/1/2 = 1e-4/0.25/0.75,
sigma1/2/3 = 0.25/0.5/4.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch import obs

Params = Union[torch.Tensor, dict]

_HOST_READS = obs.counter("tron.host_reads")
_CG_STEPS = obs.counter("tron.cg_steps")
obs.declare("tron.minimize", "tron.iter", "tron.cg_step", "tron.read")


@dataclasses.dataclass
class TronResult:
    params: Params
    fun: float
    grad_norm: float
    n_iter: int
    converged: bool


def ravel_params(params: Params) -> Tuple[torch.Tensor, Callable]:
    """→ (flat tensor, unravel): a dict's tensors in sorted key order,
    or a tensor as it is.  Leaves of one dtype give a flat tensor of that
    dtype and an unravel that keeps the dtype of the flat tensor it is
    given; leaves of several give a float32 one (the float32 params
    here), which unravel casts back leaf by leaf."""
    if isinstance(params, torch.Tensor):
        shape = params.shape
        return params.reshape(-1), lambda f: f.view(shape)
    names = sorted(params)
    shapes = [params[name].shape for name in names]
    sizes = [params[name].numel() for name in names]
    dtypes = {params[name].dtype for name in names}
    one = len(dtypes) == 1
    flat = torch.cat([params[name].reshape(-1).to(
        next(iter(dtypes)) if one else torch.float32) for name in names])
    back = {name: params[name].dtype for name in names}

    def unravel(f: torch.Tensor) -> dict:
        return {name: (part if one else part.to(back[name])).view(shape)
                for name, part, shape
                in zip(names, torch.split(f, sizes), shapes)}

    return flat, unravel


def _wide(*xs):
    """``xs`` in their common dtype, as jnp promotes arrays: a 0-d
    float32 tensor widens a bfloat16 vector (torch's own rule would keep
    the vector's dtype), and ``@`` takes two of one dtype."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return tuple(x.to(dtype) for x in xs)


def _dot(a, b):
    a, b = _wide(a, b)
    return a @ b


def _axpy(x, alpha, y):
    """x + alpha·y in the common dtype of the three."""
    x, alpha, y = _wide(x, alpha, y)
    return x + alpha * y


def _read(x: torch.Tensor):
    """A 0-d tensor on the host (a float, or a bool for a comparison): one
    read of the device, counted and timed."""
    _HOST_READS.add()
    with obs.span("tron.read"):
        return x.item()


def _cg_steihaug(hvp, g, delta, cg_tol, cg_max):
    """Solves H s = -g within ||s|| ≤ delta.  Returns (s, hit_boundary)."""
    s = torch.zeros_like(g)
    r = -g
    d = r
    rTr = r @ r
    g_norm = torch.sqrt(g @ g)
    for _ in range(cg_max):
        if _read(torch.sqrt(rTr) <= cg_tol * g_norm):
            return s, False
        with obs.span("tron.cg_step"):
            _CG_STEPS.add()
            Hd = hvp(d)
            dHd = _dot(d, Hd)
            if _read(dHd <= 0):
                return _axpy(s, _boundary_tau(s, d, delta), d), True
            alpha = rTr / dHd
            s_next = _axpy(s, alpha, d)
            if _read(torch.sqrt(s_next @ s_next) >= delta):
                return _axpy(s, _boundary_tau(s, d, delta), d), True
            s = s_next
            r = _axpy(r, -alpha, Hd)
            rTr_new = r @ r
            d = _axpy(r, rTr_new / rTr, d)
            rTr = rTr_new
    return s, False


def _boundary_tau(s, d, delta):
    """Positive root of ||s + tau·d|| = delta."""
    sd = _dot(s, d)
    dd = d @ d
    ss = s @ s
    rad = torch.sqrt(sd * sd + dd * (delta * delta - ss))
    return (rad - sd) / dd


def tron_minimize(
    fun: Callable,
    w0: Params,
    *,
    hvp: Optional[Callable] = None,
    max_iter: int = 100,
    cg_max: int = 30,
    cg_tol: float = 0.1,
    grad_tol: float = 1e-4,
) -> TronResult:
    """Minimizes ``fun(params)`` (full-batch, deterministic closure).

    ``hvp(params, v) -> params`` optionally supplies an analytic
    Hessian-vector product, called with one params object an iterate;
    without it Hv comes from double backward through ``fun``.
    """
    with obs.span("tron.minimize"):
        flat0, unravel = ravel_params(w0)

        def val_and_grad(w):
            w = w.detach().requires_grad_(True)
            with torch.enable_grad():
                f = fun(unravel(w))
                (g,) = torch.autograd.grad(f, w)
            return f.detach(), g

        def val_only(w):
            with torch.no_grad():
                return fun(unravel(w))

        if hvp is None:
            def hessian(w):
                def hv(v):
                    wg = w.detach().requires_grad_(True)
                    with torch.enable_grad():
                        (g,) = torch.autograd.grad(fun(unravel(wg)), wg,
                                                   create_graph=True)
                        (out,) = torch.autograd.grad(g, wg, grad_outputs=v)
                    return out
                return hv
        else:
            def hessian(w):
                at = unravel(w)
                return lambda v: ravel_params(hvp(at, unravel(v)))[0]

        w = flat0.detach()
        f, g = val_and_grad(w)
        H = hessian(w)                     # v -> Hv at the iterate w
        g0_norm = _read(torch.linalg.norm(g))
        delta = g0_norm
        eta0, eta1, eta2 = 1e-4, 0.25, 0.75
        sigma1, sigma2, sigma3 = 0.25, 0.5, 4.0

        converged = False
        it = 0
        for it in range(1, max_iter + 1):
            with obs.span("tron.iter"):
                gnorm = _read(torch.linalg.norm(g))
                if gnorm <= grad_tol * max(g0_norm, 1e-12):
                    converged = True
                    break
                s, _ = _cg_steihaug(H, g, delta, cg_tol, cg_max)
                f_new = val_only(w + s)
                gs = _read(_dot(g, s))
                sHs = _read(_dot(s, H(s)))
                pred = -(gs + 0.5 * sHs)             # predicted decrease
                actual = _read(f - f_new)
                rho = actual / pred if pred > 0 else -1.0
                snorm = _read(torch.linalg.norm(s))
                # LIBLINEAR-style delta update
                if rho < eta0:
                    delta = sigma1 * min(delta, snorm)
                elif rho < eta1:
                    delta = max(sigma1 * delta, min(snorm, sigma2 * delta))
                elif rho < eta2:
                    delta = max(sigma1 * delta, min(snorm * sigma3, delta))
                else:
                    delta = max(delta, min(snorm * sigma3, 1e10))
                if rho > eta0:
                    w = w + s
                    f, g = val_and_grad(w)
                    H = hessian(w)
        return TronResult(params=unravel(w), fun=_read(f),
                          grad_norm=_read(torch.linalg.norm(g)), n_iter=it,
                          converged=converged)
