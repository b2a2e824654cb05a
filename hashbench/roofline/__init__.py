"""The least work of each kernel on the measured paths, from shapes and
the algorithm alone (never from how a kernel is written), so the counts
read the same work whatever implements it: ``cost(...) -> (ops, bytes)``
in ``b1`` (minwise encode and pack), ``b2`` (densified OPH encode and
pack), ``b7`` (the b-bit forward product) and ``b8`` (its transpose,
dW), and the card's peaks in ``peaks``.

Bytes count each input byte the algorithm needs read once and each
output byte written once; operations count what the algorithm must
compute on these inputs.  ``least_seconds`` is the larger of operations
over the operations peak and bytes over the bandwidth.
"""
from __future__ import annotations

from typing import Optional, Tuple


def least_seconds(cost: Tuple[float, float], ops_per_s: Optional[float],
                  bytes_per_s: float) -> float:
    ops, nbytes = cost
    t = nbytes / bytes_per_s
    if ops_per_s:
        t = max(t, ops / ops_per_s)
    return t
