"""B7's device time against the least time of its calls over the window.

A fit's accuracy pass makes one forward product over the test codes;
every other B7 call is over the training codes.  Each call's least time
is ``roofline.b7``'s bytes at the card's bandwidth.
"""
from hashbench.roofline import b7, least_seconds

KERNELS = ("bbit_linear_fwd_kernel", "sum_splits_kernel")


def read(rec):
    t = rec.kernel_seconds(KERNELS)
    calls = rec.counter("bbit_linear_fwd")
    if t is None or rec.peaks is None or calls <= rec.calls:
        return None
    s = rec.shapes
    bw = rec.peaks["hbm_bytes_per_s"]
    fp = rec.peaks["fp32_ops_per_s"]
    tr = least_seconds(b7.cost(s["train_rows"], s["k"], s["n_out"],
                               s["train_distinct"]), fp, bw)
    te = least_seconds(b7.cost(s["test_rows"], s["k"], s["n_out"],
                               s["test_distinct"]), fp, bw)
    return 100.0 * ((calls - rec.calls) * tr + rec.calls * te) / t
