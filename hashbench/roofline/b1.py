"""B1: minwise hashing, b-bit, packed (k multiply-shift + fmix32 hashes a
nonzero, the minimum of each).

Integer operations an evaluation needs, one per machine instruction:

    a·t + b                     1  (multiply-add)
    h ^= h >> 16                2  (shift, xor)
    h *= 0x85EBCA6B             1
    h ^= h >> 13                2
    h *= 0xC2B2AE35             1
    h ^= h >> 16                2
    running minimum             1
                               --
                               10

The b-bit mask and the packing are per code, not per evaluation, and are
left out (a lower bound).  Bytes: each valid id and each row's nnz read
once (int32), the packed rows written once.
"""
from __future__ import annotations

OPS_PER_EVAL = 10


def cost(nnz_total: int, rows: int, k: int, bits: int):
    ops = OPS_PER_EVAL * nnz_total * k
    nbytes = 4 * nnz_total + 4 * rows + rows * -(-k * bits // 8)
    return ops, nbytes
