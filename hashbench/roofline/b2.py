"""B2: one permutation hashing, densified, b-bit, packed (one hash a
nonzero, the minimum of its bin).

Integer operations a nonzero needs: the hash's 9 (see ``b1``), the bin's
shift and the bin minimum's 1, 11 in all; densification and packing are
per bin and left out.  Bytes: each valid id and each row's nnz read once
(int32), the packed rows written once, and the packbits empty mask
(ceil(k/8) bytes a row) only where the scheme returns it (zero-coded
OPH; the densified scheme returns none).
"""
from __future__ import annotations

OPS_PER_NONZERO = 11


def cost(nnz_total: int, rows: int, k: int, bits: int, mask: bool = False):
    ops = OPS_PER_NONZERO * nnz_total
    nbytes = (4 * nnz_total + 4 * rows + rows * -(-k * bits // 8)
              + (rows * -(-k // 8) if mask else 0))
    return ops, nbytes
