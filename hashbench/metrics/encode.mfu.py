"""A pass's least time (the sum of its chunks' least times, ``roofline.b1``
for minwise, ``roofline.b2`` for OPH) over the pass's wall time."""
from hashbench.roofline import b1, b2, least_seconds

COST = {"minwise": b1.cost, "oph": b2.cost}


def read(rec):
    s = rec.shapes
    cost = COST.get(s.get("scheme"))
    if cost is None or rec.peaks is None or not rec.calls:
        return None
    ops = rec.peaks.get("int32_ops_per_s")
    if s["scheme"] == "minwise" and not ops:
        return None
    one_pass = sum(least_seconds(cost(nnz, rows, s["k"], s["bits"]), ops,
                                 rec.peaks["hbm_bytes_per_s"])
                   for rows, nnz in s["chunks"])
    return 100.0 * one_pass / (rec.wall_s / rec.calls)
