"""The model FLOPs of the window's prefills (``roofline.mla``, from the
shapes) over the window's seconds times the card's dense bf16 rate."""
from hashbench.roofline import mla


def read(rec):
    s = rec.shapes
    if "model" not in s or rec.peaks is None or not rec.calls:
        return None
    cycles = rec.calls / len(s["cycle"])
    flops = cycles * sum(mla.prefill_flops(s["model"], b, n)
                         for b, n in s["cycle"])
    return 100.0 * flops / (rec.wall_s * mla.BF16_DENSE_FLOPS_PER_S)
