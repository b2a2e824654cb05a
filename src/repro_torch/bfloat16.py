"""bfloat16 params between torch and numpy, bit for bit.

numpy has no bfloat16 of its own.  JAX hands one over as an ``ml_dtypes``
``bfloat16`` array, and checkpoints (both packages') store one as 2-byte
void words (``|V2``).  The port imports neither JAX nor ``ml_dtypes``, so
it recognises both by their dtype's name or kind and size, and moves the
16-bit words as they are.
"""
from __future__ import annotations

import numpy as np
import torch


def is_bfloat16_array(arr: np.ndarray) -> bool:
    """Whether a numpy array holds bfloat16 words: ``ml_dtypes``'
    bfloat16, or the 2-byte void words checkpoints store it as."""
    return arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                            and arr.dtype.itemsize == 2)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; a bfloat16 one as its 2-byte words
    (void, ``|V2``), as the reference's checkpoints store it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(arr) -> torch.Tensor:
    """An array of bfloat16 words (``is_bfloat16_array``) as a CPU
    bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.array(arr).view(np.int16)).view(
        torch.bfloat16)


def cast_like(arr, want: np.dtype) -> np.ndarray:
    """``arr`` cast to numpy dtype ``want``, where either may hold
    bfloat16 words: words to words as they are, wider floats to words
    rounded to nearest even (as torch and ``ml_dtypes`` round), words to
    a float dtype exactly."""
    arr = np.asarray(arr)
    src, dst = is_bfloat16_array(arr), want.kind == "V" and want.itemsize == 2
    if not src and not dst:
        return arr.astype(want)
    t = from_numpy(arr) if src else torch.from_numpy(
        np.asarray(arr, np.float32))
    if dst:
        return to_numpy(t.to(torch.bfloat16)).view(want)
    return t.to(torch.float32).numpy().astype(want)
