"""Share of B7's calls that walked the bins in L2-sized slices:
``bbit_linear_fwd_sliced`` over B7's launches (``bbit_linear_fwd``, and
``bbit_linear_fwd_bf16`` for a bfloat16 table) in the window; none where
the program has no such counter or launched no B7."""

SLICED = "bbit_linear_fwd_sliced"
CALLS = ("bbit_linear_fwd", "bbit_linear_fwd_bf16")


def read(rec):
    calls = rec.counter(*CALLS)
    if SLICED not in rec.counters or not calls:
        return None
    return 100.0 * rec.counter(SLICED) / calls
