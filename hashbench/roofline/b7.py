"""B7: the b-bit forward product, logits (n, C) = Σ_j W[j, code(n, j)].

Bytes: each int32 code read once, each table row (C float32 values) that
the codes gather read once (``distinct``: the (j, code) pairs that occur),
the logits written once.  Operations: one add a code and output column
(float32).
"""
from __future__ import annotations


def cost(rows: int, k: int, n_out: int, distinct: int, value_bytes: int = 4):
    ops = rows * k * n_out
    nbytes = 4 * rows * k + value_bytes * distinct * n_out + 4 * rows * n_out
    return ops, nbytes
