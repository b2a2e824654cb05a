"""b-bit codes, their packing and storage accounting (counterpart of
``repro/core/bbit.py``).

One bit layout everywhere: a row-major bitstream, LSB-first within each
byte, ceil(k·b/8) bytes per row.  The ``oph_zero`` empty-bin mask uses
the ``np.packbits`` layout (MSB-first), ceil(k/8) bytes per row.  The
numpy functions are copies of the reference's; the torch functions are
the twins of its ``*_jnp`` packers and run on any device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def bbit_codes(z, b: int):
    """Lowest b bits of each min-hash value: uint16 codes for a numpy
    array, int32 codes for a tensor (int64 words; CUDA torch has little
    uint16 support, and every code in [0, 2^16) fits int32)."""
    if not 1 <= b <= 16:
        raise ValueError(f"b must be in [1, 16], got {b}")
    mask = (1 << b) - 1
    if isinstance(z, np.ndarray):
        return (z & np.asarray(mask, dtype=z.dtype)).astype(np.uint16)
    return (z & mask).to(torch.int32)


def storage_bits(n: int, k: int, b: int) -> int:
    """Exact storage of the hashed dataset: n·b·k bits (paper §3)."""
    return n * b * k


def vw_storage_bits(n: int, k: int, bits_per_entry: int = 32) -> int:
    """VW stores k dense (float/int) bins per example (paper §5.3)."""
    return n * k * bits_per_entry


def codes_agree(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """\\hat{P}_b per pair: the fraction of agreeing b-bit codes (paper
    Eq. 6), float32 over the last axis: the exact count times the
    float32 reciprocal of k, which is how XLA rounds the reference's
    ``jnp.mean`` (torch's own ``mean`` can differ in the last bit)."""
    agree = (c1 == c2).sum(dim=-1).to(torch.float32)
    return agree * float(np.float32(1) / np.float32(c1.shape[-1]))


def pack_codes(codes: np.ndarray, b: int) -> np.ndarray:
    """Bit-packs uint16 (n, k) codes (< 2^b) into a uint8 (n, ceil(k·b/8))."""
    n, k = codes.shape
    codes = codes.astype(np.uint32)
    bits = ((codes[:, :, None] >> np.arange(b, dtype=np.uint32)[None, None, :])
            & 1).astype(np.uint8)          # (n, k, b) LSB-first
    flat = bits.reshape(n, k * b)
    pad = (-flat.shape[1]) % 8
    if pad:
        flat = np.pad(flat, ((0, 0), (0, pad)))
    flat = flat.reshape(n, -1, 8)
    weights = (1 << np.arange(8, dtype=np.uint16)).astype(np.uint8)
    return (flat * weights[None, None, :]).sum(axis=2).astype(np.uint8)


def packed_width(k: int, b: int) -> int:
    """Bytes per row of the packed code matrix: ceil(k·b/8)."""
    return (k * b + 7) // 8


def packed_mask_width(k: int) -> int:
    """Bytes per row of the packed ``oph_zero`` empty bitmask: ceil(k/8)."""
    return (k + 7) // 8


def unpack_codes(packed: np.ndarray, k: int, b: int) -> np.ndarray:
    """Inverse of ``pack_codes`` → uint16 (n, k)."""
    n = packed.shape[0]
    bits = ((packed[:, :, None] >> np.arange(8, dtype=np.uint8)[None, None, :])
            & 1)
    flat = bits.reshape(n, -1)[:, : k * b].reshape(n, k, b)
    weights = (1 << np.arange(b, dtype=np.uint32))
    return (flat.astype(np.uint32) * weights[None, None, :]).sum(axis=2).astype(
        np.uint16
    )


def pack_codes_torch(codes: torch.Tensor, b: int) -> torch.Tensor:
    """Torch ``pack_codes``: integer (n, k) codes < 2^b → uint8."""
    n, k = codes.shape
    c = codes.to(torch.int64)
    if 8 % b == 0:
        r = 8 // b
        c = F.pad(c, (0, (-k) % r))
        out = torch.zeros((n, c.shape[1] // r), dtype=torch.int64,
                          device=c.device)
        for t in range(r):
            out |= c[:, t::r] << (t * b)
        return out.to(torch.uint8)
    shifts = torch.arange(b, dtype=torch.int64, device=c.device)
    flat = ((c[:, :, None] >> shifts) & 1).reshape(n, k * b)
    flat = F.pad(flat, (0, (-flat.shape[1]) % 8)).reshape(n, -1, 8)
    weights = 1 << torch.arange(8, dtype=torch.int64, device=c.device)
    return (flat * weights).sum(dim=2).to(torch.uint8)


def pack_mask_torch(mask: torch.Tensor) -> torch.Tensor:
    """Torch ``np.packbits(mask, axis=1)`` (MSB-first) → uint8."""
    n, k = mask.shape
    m = F.pad(mask.to(torch.int64), (0, (-k) % 8))
    out = torch.zeros((n, m.shape[1] // 8), dtype=torch.int64,
                      device=mask.device)
    for t in range(8):
        out |= m[:, t::8] << (7 - t)
    return out.to(torch.uint8)


def unpack_codes_torch(packed: torch.Tensor, k: int, b: int) -> torch.Tensor:
    """Inverse of ``pack_codes_torch`` → int64 (n, k)."""
    n = packed.shape[0]
    p = packed.to(torch.int64)
    if 8 % b == 0:
        r = 8 // b
        cols = torch.stack([(p >> (t * b)) & ((1 << b) - 1)
                            for t in range(r)], dim=2)
        return cols.reshape(n, -1)[:, :k]
    shifts = torch.arange(8, dtype=torch.int64, device=p.device)
    flat = ((p[:, :, None] >> shifts) & 1).reshape(n, -1)[:, : k * b]
    weights = 1 << torch.arange(b, dtype=torch.int64, device=p.device)
    return (flat.reshape(n, k, b) * weights).sum(dim=2)


def unpack_mask_torch(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Torch ``np.unpackbits(packed, axis=1, count=k)`` → bool (n, k)."""
    n = packed.shape[0]
    p = packed.to(torch.int64)
    cols = torch.stack([(p >> (7 - t)) & 1 for t in range(8)], dim=2)
    return cols.reshape(n, -1)[:, :k] != 0
