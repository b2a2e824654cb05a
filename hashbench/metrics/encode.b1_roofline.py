"""B1's device time against the least time of its calls over the window:
``roofline.b1``'s operations at the int32 rate derived from the card
(``roofline.peaks``), or its bytes at the bandwidth where that is
longer; one call a chunk a pass."""
from hashbench.roofline import b1, least_seconds

KERNELS = ("minhash_pack_kernel",)


def read(rec):
    t = rec.kernel_seconds(KERNELS)
    s = rec.shapes
    if (t is None or rec.peaks is None or s.get("scheme") != "minwise"
            or not rec.peaks.get("int32_ops_per_s")):
        return None
    one_pass = sum(least_seconds(b1.cost(nnz, rows, s["k"], s["bits"]),
                                 rec.peaks["int32_ops_per_s"],
                                 rec.peaks["hbm_bytes_per_s"])
                   for rows, nnz in s["chunks"])
    return 100.0 * rec.calls * one_pass / t
