"""TRON, LIBLINEAR's trust-region Newton-CG (tron.cpp), on the b-bit
linear model of ``linear``, plain torch in one dtype.

The outer loop accepts a step s when the actual decrease is more than
eta0 of the predicted one, -(gᵀs + sᵀHs/2), and scales the trust radius
by sigma1..3 with the ratio (eta 1e-4/0.25/0.75, sigma 0.25/0.5/4); the
inner loop is Steihaug's CG on H s = -g within the radius, stopped at a
residual of ``cg_tol``·‖g‖.  H v = v + C·Xᵀ(D·X v), D = σ(m)(1 − σ(m))
at the iterate's margins.  It stops when ‖g‖ ≤ ``grad_tol``·‖g(w0)‖ or
after ``max_iter`` iterations, starting from w = 0.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from hashbench.reference import linear


@dataclasses.dataclass
class Fit:
    table: torch.Tensor
    bias: torch.Tensor
    objective: float
    train_acc: float
    test_acc: float
    n_iter: int


def fit(codes_tr, y_tr, codes_te, y_te, *, k: int, vsize: int, C: float,
        dtype: torch.dtype, max_iter: int, cg_max: int, cg_tol: float,
        grad_tol: float) -> Fit:
    dev = codes_tr.device
    n_w = k * vsize + 1                      # the table, then the bias
    y = linear.signs(y_tr, dtype)

    def split(w):
        return w[:-1].view(k, vsize, 1), w[-1]

    def margins(w):
        return y * linear.forward(*split(w), codes_tr, dtype)

    def value(w):
        return float(0.5 * (w * w).sum()
                     + C * torch.nn.functional.softplus(-margins(w)).sum())

    def grad(w, m):
        gt, gb = linear.transpose(codes_tr, -C * y * torch.sigmoid(-m), k,
                                  vsize, dtype)
        return w + torch.cat([gt.reshape(-1), gb.reshape(1)])

    def hess(d2, v):
        xv = linear.forward(*split(v), codes_tr, dtype)
        ht, hb = linear.transpose(codes_tr, C * d2 * xv, k, vsize, dtype)
        return v + torch.cat([ht.reshape(-1), hb.reshape(1)])

    def dot(a, b):
        return float((a * b).sum())

    w = torch.zeros(n_w, dtype=dtype, device=dev)
    m = margins(w)
    f, g = value(w), grad(w, m)
    g0 = math.sqrt(dot(g, g))
    delta = g0
    it = 0
    for it in range(1, max_iter + 1):
        if math.sqrt(dot(g, g)) <= grad_tol * max(g0, 1e-12):
            break
        sig = torch.sigmoid(m)
        d2 = sig * (1 - sig)
        s = torch.zeros_like(w)
        r = -g
        d = r.clone()
        rr = dot(r, r)
        gnorm = math.sqrt(dot(g, g))
        for _ in range(cg_max):
            if math.sqrt(rr) <= cg_tol * gnorm:
                break
            hd = hess(d2, d)
            dhd = dot(d, hd)
            alpha = rr / dhd if dhd > 0 else math.inf
            s_next = s + alpha * d if dhd > 0 else None
            if s_next is None or math.sqrt(dot(s_next, s_next)) >= delta:
                sd, dd, ss = dot(s, d), dot(d, d), dot(s, s)
                tau = (math.sqrt(sd * sd + dd * (delta * delta - ss)) - sd) / dd
                s = s + tau * d
                break
            s = s_next
            r = r - alpha * hd
            rr_new = dot(r, r)
            d = r + (rr_new / rr) * d
            rr = rr_new
        w_new = w + s
        m_new = margins(w_new)
        f_new = value(w_new)
        gs, shs = dot(g, s), dot(s, hess(d2, s))
        pred = -(gs + 0.5 * shs)
        rho = (f - f_new) / pred if pred > 0 else -1.0
        snorm = math.sqrt(dot(s, s))
        if rho < 1e-4:
            delta = 0.25 * min(delta, snorm)
        elif rho < 0.25:
            delta = max(0.25 * delta, min(snorm, 0.5 * delta))
        elif rho < 0.75:
            delta = max(0.25 * delta, min(4.0 * snorm, delta))
        else:
            delta = max(delta, min(4.0 * snorm, 1e10))
        if rho > 1e-4:
            w, m, f = w_new, m_new, f_new
            g = grad(w, m)
    table, bias = split(w)
    bias = bias.reshape(1)
    return Fit(table, bias, f,
               linear.accuracy(table, bias, codes_tr, y_tr, dtype),
               linear.accuracy(table, bias, codes_te, y_te, dtype), it)
