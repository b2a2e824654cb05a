"""The card's peaks.

HBM bandwidth and the float32 rate are NVIDIA's published figures for
the H100 SXM5 80GB (data sheet; dense, no sparsity), at its 700 W limit.
NVIDIA publishes no int32 rate, so it is derived from the card itself:
an SM has 4 sub-partitions, each dispatching one warp instruction (32
lanes) a clock, so no kernel runs more than SMs × 4 × 32 integer
operations a clock, at the card's highest SM clock (``nvidia-smi``'s
``clocks.max.sm``).  That is an upper bound of the int32 rate (some
integer instructions run at half of it), so a share of it never passes
100 %.
"""
from __future__ import annotations

import subprocess
from typing import Optional

import torch

PUBLISHED = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_ops_per_s": 67e12},
}
LANES_A_CLOCK_PER_SM = 4 * 32


def max_sm_clock_hz(index: int) -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def for_device(device: torch.device) -> Optional[dict]:
    """{hbm_bytes_per_s, fp32_ops_per_s, int32_ops_per_s (or None),
    sm_count, max_sm_clock_hz} of a card in ``PUBLISHED``, else None."""
    if device.type != "cuda":
        return None
    index = device.index or 0
    peaks = PUBLISHED.get(torch.cuda.get_device_name(index))
    if peaks is None:
        return None
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    clock = max_sm_clock_hz(index)
    return dict(peaks, sm_count=sms, max_sm_clock_hz=clock,
                int32_ops_per_s=(sms * LANES_A_CLOCK_PER_SM * clock
                                 if clock else None))
