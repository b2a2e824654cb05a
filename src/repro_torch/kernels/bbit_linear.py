"""Packed-input b-bit linear forward: kernel B5 and its plain version
(counterpart of ``repro/kernels/bbit_linear.py``'s packed forward).

    logits[n, c] = Σ_j W[j, code(n, j), c]

straight from the packed uint8 rows (``core.bbit`` layout); an optional
packbits empty mask (``oph_zero``) drops the marked bins.
``bbit_linear_packed_fwd`` launches the CUDA kernel of
``csrc/bbit_linear.cu`` on CUDA tensors and takes the plain version on
CPU tensors.  The kernel sums in another order than torch, so the two
agree to float32 rounding (allclose), not bit for bit; the kernel
itself is run-to-run deterministic.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bbit import (packed_mask_width, packed_width,
                                   unpack_codes_torch, unpack_mask_torch)
from repro_torch.kernels import _build
from repro_torch.kernels.counters import LaunchCount
from repro_torch.kernels.fused_encode import check_bits


def bbit_linear_packed_fwd_plain(packed: torch.Tensor,
                                 weights: torch.Tensor, *, k: int, bits: int,
                                 empty: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """B5's plain version: unpack → gather → mask → sum in torch ops on
    the inputs' device, for any b; the semantics of the reference's
    ``ref.bbit_linear_packed_fwd``."""
    codes = unpack_codes_torch(packed, k, bits)
    j = torch.arange(k, device=packed.device)
    gathered = weights[j[None, :], codes].to(torch.float32)   # (n, k, C)
    if empty is not None:
        gathered = gathered.masked_fill(
            unpack_mask_torch(empty, k)[:, :, None], 0.0)
    return gathered.sum(dim=1)


def bbit_linear_packed_fwd(packed: torch.Tensor, weights: torch.Tensor, *,
                           k: int, bits: int,
                           empty: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """logits f32 (n, C) from packed uint8 (n, ceil(k·bits/8)), table
    f32 (k, V, C) with V ≥ 2^bits, and ``empty`` uint8 (n, ceil(k/8))
    or None."""
    check_bits(bits)
    if _build.on_cpu("bbit_linear_packed_fwd", packed):
        return bbit_linear_packed_fwd_plain(packed, weights, k=k, bits=bits,
                                            empty=empty)
    n = packed.shape[0]
    if packed.dtype != torch.uint8 or packed.shape != (n, packed_width(k, bits)):
        raise ValueError(f"packed must be uint8 (n, {packed_width(k, bits)}),"
                         f" got {packed.dtype} {tuple(packed.shape)}")
    if (weights.dtype != torch.float32 or weights.dim() != 3
            or weights.shape[0] != k or weights.shape[1] < (1 << bits)):
        raise ValueError(f"weights must be float32 (k={k}, V>={1 << bits}, "
                         f"C), got {weights.dtype} {tuple(weights.shape)}")
    tensors = [packed, weights]
    if empty is not None:
        if empty.dtype != torch.uint8 or empty.shape != (n, packed_mask_width(k)):
            raise ValueError(f"empty must be uint8 (n, {packed_mask_width(k)})"
                             f", got {empty.dtype} {tuple(empty.shape)}")
        tensors.append(empty)
    for t in tensors:
        if t.device != packed.device or not t.is_contiguous():
            raise ValueError("bbit_linear_packed_fwd: inputs must be "
                             f"contiguous and on {packed.device}")
    v, c = weights.shape[1], weights.shape[2]
    out = torch.empty((n, c), dtype=torch.float32, device=packed.device)
    lib = _build.load("bbit_linear")
    with torch.cuda.device(packed.device):
        code = lib.repro_bbit_linear_packed_fwd(
            packed.data_ptr(), weights.data_ptr(),
            None if empty is None else empty.data_ptr(), out.data_ptr(),
            n, k, bits, v, c, packed.shape[1],
            0 if empty is None else empty.shape[1],
            packed.device.index, _build.stream(packed))
    _build.check("bbit_linear", code, "bbit_linear_packed_fwd")
    bbit_linear_packed_fwd.launches.add()
    return out


bbit_linear_packed_fwd.launches = LaunchCount()
