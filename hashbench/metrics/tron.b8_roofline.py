"""B8's device time (its sums over the cached plan) against the least
time of its calls over the window, ``roofline.b8``'s bytes at the card's
bandwidth; every B8 call is over the training codes."""
from hashbench.roofline import b8, least_seconds

KERNELS = ("dw_sum_kernel",)


def read(rec):
    t = rec.kernel_seconds(KERNELS)
    calls = rec.counter("bbit_linear_bwd_dw")
    if t is None or rec.peaks is None or not calls:
        return None
    s = rec.shapes
    one = least_seconds(b8.cost(s["train_rows"], s["k"], s["vsize"],
                                s["n_out"]),
                        rec.peaks["fp32_ops_per_s"],
                        rec.peaks["hbm_bytes_per_s"])
    return 100.0 * calls * one / t
