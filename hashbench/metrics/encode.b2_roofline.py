"""B2's device time against the least time of its calls over the window:
``roofline.b2``'s bytes at the card's bandwidth (or its operations at the
derived int32 rate where that is longer); one call a chunk a pass."""
from hashbench.roofline import b2, least_seconds

KERNELS = ("oph_pack_kernel",)


def read(rec):
    t = rec.kernel_seconds(KERNELS)
    s = rec.shapes
    if t is None or rec.peaks is None or s.get("scheme") != "oph":
        return None
    one_pass = sum(least_seconds(b2.cost(nnz, rows, s["k"], s["bits"]),
                                 rec.peaks.get("int32_ops_per_s"),
                                 rec.peaks["hbm_bytes_per_s"])
                   for rows, nnz in s["chunks"])
    return 100.0 * rec.calls * one_pass / t
