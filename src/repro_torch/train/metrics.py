"""Evaluation metrics (counterpart of ``repro/train/metrics.py``)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def accuracy(pred, labels) -> float:
    """Share of rows where ``pred`` equals ``labels`` (tensors or arrays)."""
    return float(np.mean(_host(pred) == _host(labels)))


def trees_bitwise_equal(a: Any, b: Any) -> bool:
    """True iff two trees (dicts, dataclasses, tuples of tensors or numpy
    arrays) hold element-wise identical leaves: the check behind every
    determinism contract of the port (prefetch depth, kill/resume,
    supervised restarts)."""
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(_host(x), _host(y)) for x, y in zip(la, lb))


def batched_accuracy(predict_fn, inputs, labels: np.ndarray,
                     batch: int = 4096) -> float:
    """Accuracy of ``predict_fn`` over ``inputs`` in slices of ``batch``
    rows."""
    hits = 0
    for lo in range(0, inputs.shape[0], batch):
        p = _host(predict_fn(inputs[lo: lo + batch]))
        hits += int((p == _host(labels[lo: lo + batch])).sum())
    return hits / inputs.shape[0]
