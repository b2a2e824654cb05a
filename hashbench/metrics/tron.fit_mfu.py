"""The least time of the b-bit products a fit needs, over the fit's wall
time.

Each transposed product (a B8 call: a gradient or a Hessian-vector
product) needs one forward product over the same training codes, and
the test accuracy one forward product over the test codes; any other
product a fit computes is not counted as needed.  Least times are
``roofline.b7`` / ``roofline.b8`` at the card's bandwidth, so the share
bounds the fit whatever kernels compute the products.
"""
from hashbench.roofline import b7, b8, least_seconds


def read(rec):
    transposes = rec.counter("bbit_linear_bwd_dw", "bbit_linear_bwd_dw_bf16",
                             "bbit_linear_bwd_dw_plain")
    if rec.peaks is None or not rec.calls or not transposes:
        return None
    s = rec.shapes
    bw, fp = rec.peaks["hbm_bytes_per_s"], rec.peaks["fp32_ops_per_s"]
    fwd_tr = least_seconds(b7.cost(s["train_rows"], s["k"], s["n_out"],
                                   s["train_distinct"]), fp, bw)
    fwd_te = least_seconds(b7.cost(s["test_rows"], s["k"], s["n_out"],
                                   s["test_distinct"]), fp, bw)
    dw = least_seconds(b8.cost(s["train_rows"], s["k"], s["vsize"],
                               s["n_out"]), fp, bw)
    need = transposes * (fwd_tr + dw) + rec.calls * fwd_te
    return 100.0 * need / rec.wall_s
