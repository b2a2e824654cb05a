"""B8: the transpose of the b-bit product, dW[j, v] = Σ_n 1{code(n, j) =
v}·dout(n).

Bytes: each int32 code read once, dout (n, C) float32 read once, the
dense dW (k, V, C) written once.  Operations: one add a code and output
column (float32).
"""
from __future__ import annotations


def cost(rows: int, k: int, vsize: int, n_out: int, value_bytes: int = 4):
    ops = rows * k * n_out
    nbytes = 4 * rows * k + 4 * rows * n_out + value_bytes * k * vsize * n_out
    return ops, nbytes
