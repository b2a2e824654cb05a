"""Objectives matching the paper's Eq. (8) (L2-SVM) and Eq. (9) (LR)
(counterpart of ``repro/train/losses.py``).

LIBLINEAR convention: f(w) = 0.5·wᵀw + C·Σᵢ ℓ(yᵢ, wᵀxᵢ), a sum over
examples scaled by C.  As in the reference, wᵀw runs over every
parameter, the bias included.  Params are dicts of tensors; their sums
run in sorted key order, the order of the reference's ``tree.leaves``.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch


def logistic(margins: torch.Tensor) -> torch.Tensor:
    """log(1 + e^{-m}), stable (paper Eq. 9)."""
    return torch.logaddexp(torch.zeros_like(margins), -margins)


def hinge(margins: torch.Tensor) -> torch.Tensor:
    """max(1 - m, 0): L1-loss SVM (paper Eq. 8)."""
    return torch.clamp(1.0 - margins, min=0.0)


def squared_hinge(margins: torch.Tensor) -> torch.Tensor:
    """max(1 - m, 0)^2: L2-loss SVM (LIBLINEAR -s 2)."""
    return torch.clamp(1.0 - margins, min=0.0) ** 2


LOSSES = {"logistic": logistic, "hinge": hinge,
          "squared_hinge": squared_hinge}


def _logistic_d2(m: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(m)
    return s * (1.0 - s)


def _squared_hinge_d2(m: torch.Tensor) -> torch.Tensor:
    # generalized Hessian (LIBLINEAR -s 2): 2·1{m < 1}
    return 2.0 * (m < 1.0).to(torch.float32)


#: second derivative of the loss in the margin, for the analytic TRON
#: Hessian-vector product Hv = v + C·Xᵀ(ℓ″(m)⊙Xv)
LOSS_D2 = {"logistic": _logistic_d2, "squared_hinge": _squared_hinge_d2}


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy of the multiclass path; int labels (n,)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[:, None])[:, 0]
    return logz - gold


def binary_margins(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """y·wᵀx with y ∈ {−1, +1} from {0, 1} labels; logits (n,) or (n, 1)."""
    if logits.dim() == 2:
        logits = logits[:, 0]
    return (2.0 * labels.to(torch.float32) - 1.0) * logits


def l2_sum(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Σ over every param of Σ p², in sorted key order."""
    return sum(torch.sum(params[name].to(torch.float32) ** 2)
               for name in sorted(params))


def liblinear_objective(forward: Callable, loss_name: str, C: float):
    """f(params, codes, labels) = 0.5‖w‖² + C·Σ ℓ, the paper's objective;
    ``forward(params, codes) -> logits``, binary labels in {0, 1}."""
    loss_fn = LOSSES[loss_name]

    def objective(params, codes, labels):
        m = binary_margins(forward(params, codes), labels)
        return 0.5 * l2_sum(params) + C * torch.sum(loss_fn(m))

    return objective


def _per_example(logits: torch.Tensor, labels: torch.Tensor,
                 loss_name: str):
    """Per-example losses and the decision rule of ``loss_name`` (argmax
    for ``"softmax"``, the sign of the margin logit otherwise), the one
    definition behind the minibatch losses and progressive validation."""
    if loss_name == "softmax":
        per = softmax_xent(logits, labels)
        pred = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        per = LOSSES[loss_name](binary_margins(logits, labels))
        z = logits[:, 0] if logits.dim() == 2 else logits
        pred = (z > 0).to(torch.int32)
    return per, pred


def mean_loss_with_preds_fn(forward: Callable, loss_name: str,
                            l2: float = 0.0):
    """Mean per-example loss, optional L2 over every param (the bias
    included), and the predicted classes of the same forward: ``f(params,
    codes, labels) -> (loss, pred)``, what the streaming trainer's
    progressive validation counts without a second forward."""
    def f(params, codes, labels):
        per, pred = _per_example(forward(params, codes), labels, loss_name)
        loss = torch.mean(per)
        if l2:
            loss = loss + 0.5 * l2 * l2_sum(params)
        return loss, pred
    return f


def sum_loss_with_hits_fn(forward: Callable, loss_name: str):
    """Masked per-example SUM loss and correct-prediction count: ``f(params,
    codes, labels, valid) -> (loss_sum, hits)`` over the rows where
    ``valid`` is set, so padded slot batches add exactly their real rows.
    The data-parallel twin of ``mean_loss_with_preds_fn``: the global
    mean, and the L2 term (which must not be summed once a slot), are
    applied by ``train.data_parallel`` after the cross-device sum."""
    def f(params, codes, labels, valid):
        per, pred = _per_example(forward(params, codes), labels, loss_name)
        loss_sum = torch.sum(per * valid.to(per.dtype))
        hits = torch.sum(torch.where(valid, (pred == labels).to(torch.int32),
                                     0))
        return loss_sum, hits
    return f


def mean_loss_fn(forward: Callable, loss_name: str, l2: float = 0.0):
    """Mean per-example loss (the minibatch path), optional L2;
    ``loss_name`` one of ``LOSSES`` or ``"softmax"``."""
    inner = mean_loss_with_preds_fn(forward, loss_name, l2)

    def f(params, codes, labels):
        return inner(params, codes, labels)[0]
    return f
