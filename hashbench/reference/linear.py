"""The b-bit linear model and the LIBLINEAR objective, plain torch.

The model over integer codes (n, k) in [0, V): logits = Σ_j W[j, code_j]
+ bias, W a (k, V, 1) table (the 2^b·k one-hot expansion).  The
objective of Eq. (9) of arXiv:1108.3072 (LIBLINEAR's convention, the
bias regularised with the table):

    f(w) = 0.5·(‖W‖² + bias²) + C·Σ_i log(1 + exp(−y_i·m_i)),  y ∈ ±1

Products run in blocks of rows, in the dtype asked for (float64 for the
check; bfloat16 for the control).
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 1 << 16


def _index(codes: torch.Tensor, vsize: int) -> torch.Tensor:
    k = codes.shape[1]
    return codes.to(torch.int64) + vsize * torch.arange(
        k, device=codes.device, dtype=torch.int64)


def forward(table: torch.Tensor, bias: torch.Tensor, codes: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """(n,) logits Σ_j W[j, code_j] + bias, in ``dtype``."""
    k, vsize = table.shape[0], table.shape[1]
    flat = table.reshape(k * vsize).to(dtype)
    out = torch.empty(codes.shape[0], dtype=dtype, device=codes.device)
    for lo in range(0, codes.shape[0], BLOCK):
        out[lo:lo + BLOCK] = flat[_index(codes[lo:lo + BLOCK],
                                         vsize)].sum(dim=1)
    return out + bias.reshape(()).to(dtype)


def transpose(codes: torch.Tensor, coef: torch.Tensor, k: int, vsize: int,
              dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Xᵀ·coef: → (table-shaped (k, V, 1) sums, the bias's sum)."""
    out = torch.zeros(k * vsize, dtype=dtype, device=codes.device)
    coef = coef.to(dtype)
    for lo in range(0, codes.shape[0], BLOCK):
        idx = _index(codes[lo:lo + BLOCK], vsize)
        out.index_add_(0, idx.reshape(-1),
                       coef[lo:lo + BLOCK, None].expand(idx.shape).reshape(-1))
    return out.view(k, vsize, 1), coef.sum()


def signs(labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return 2 * labels.to(dtype) - 1


def objective(table, bias, codes, labels, C: float,
              dtype: torch.dtype = torch.float64) -> float:
    m = signs(labels, dtype) * forward(table, bias, codes, dtype)
    reg = (table.to(dtype) ** 2).sum() + (bias.to(dtype) ** 2).sum()
    return float(0.5 * reg + C * torch.nn.functional.softplus(-m).sum())


def gradient(table, bias, codes, labels, C: float,
             dtype: torch.dtype = torch.float64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """∇f as (table-shaped, bias-shaped) tensors."""
    y = signs(labels, dtype)
    coef = -C * y * torch.sigmoid(-y * forward(table, bias, codes, dtype))
    gt, gb = transpose(codes, coef, table.shape[0], table.shape[1], dtype)
    return table.to(dtype) + gt, bias.reshape(()).to(dtype) + gb


def accuracy(table, bias, codes, labels,
             dtype: torch.dtype = torch.float64) -> float:
    """Share of rows whose class (logit > 0 → 1) equals the label."""
    pred = forward(table, bias, codes, dtype) > 0
    return float((pred == labels.bool()).double().mean())
