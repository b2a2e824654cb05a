"""Launches of B7 and B8 a fit: their ``ops.counts()`` over the window
(both table dtypes), over the fits."""

NAMES = ("bbit_linear_fwd", "bbit_linear_bwd_dw", "bbit_linear_fwd_bf16",
         "bbit_linear_bwd_dw_bf16")


def read(rec):
    return rec.counter(*NAMES) / rec.calls if rec.calls else None
