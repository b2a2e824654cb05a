"""Evaluation metrics (counterpart of ``repro/train/metrics.py``)."""
from __future__ import annotations

import numpy as np
import torch


def accuracy(pred, labels) -> float:
    """Share of rows where ``pred`` equals ``labels`` (tensors or arrays)."""
    if isinstance(pred, torch.Tensor):
        pred = pred.cpu().numpy()
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    return float(np.mean(np.asarray(pred) == np.asarray(labels)))
