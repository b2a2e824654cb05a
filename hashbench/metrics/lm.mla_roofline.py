"""The prefill attention's least time (its causal q·k and p·v FLOPs at
the card's dense bf16 rate, ``roofline.mla``) over the device time of
the fused attention kernels (``mla.ATTENTION_KERNELS``) in the window."""
from hashbench.roofline import mla


def read(rec):
    s = rec.shapes
    if "model" not in s or not rec.calls:
        return None
    t = rec.kernel_seconds(mla.ATTENTION_KERNELS)
    if t is None:
        return None
    cycles = rec.calls / len(s["cycle"])
    flops = cycles * sum(mla.attention_flops(s["model"], b, n)
                         for b, n in s["cycle"])
    return 100.0 * flops / mla.BF16_DENSE_FLOPS_PER_S / t
