"""Dispatch between the kernels and their plain torch versions (forward
serving path of ``repro/kernels/ops.py``).

The eligibility predicates are the reference's static rules:

  * fused encode (B1, B2) needs b ∈ {1, 2, 4, 8}, so codes never
    straddle a byte (``fused_pack_supported``);
  * the packed linear kernel (B5) also needs 2^b ≤ ``BBIT_KERNEL_MAX_V``
    (``packed_kernel_supported``).

Inside eligibility a call on a CUDA tensor goes to the kernel wrapper,
which launches its kernel (counted in the wrapper's ``launches``) or
raises.  Every other call runs the operation's plain torch version on
the tensors' own device and is counted in the operation's ``plain``
counter: a CPU tensor, or b outside eligibility (b = 6, b = 16, …),
where the reference itself runs plain XLA code.  So on a card the
``plain`` counters of the main path stay at zero.  Nothing here
catches a kernel's failure.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bbit_linear as _bl
from repro_torch.kernels import fused_encode as _fe
from repro_torch.kernels.counters import LaunchCount

PACK_BITS = _fe.PACK_BITS
BBIT_KERNEL_MAX_V = 4096


def fused_pack_supported(bits: int) -> bool:
    """Whether the fused hash→b-bit→pack kernels handle b=bits."""
    return bits in PACK_BITS


def packed_kernel_supported(bits: int, v: int) -> bool:
    """Whether the packed-input linear kernel handles (b=bits, V=v)."""
    return bits in PACK_BITS and v <= BBIT_KERNEL_MAX_V


def _launches(t: torch.Tensor, what: str, eligible: bool) -> bool:
    """Whether the call goes to the kernel: eligible and on a card."""
    return eligible and not _build.on_cpu(what, t)


def minhash_packed(indices: torch.Tensor, nnz: torch.Tensor,
                   a: torch.Tensor, b: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """min-hash + b-bit + pack → uint8 (n, ceil(k·bits/8))."""
    if _launches(indices, "minhash_pack", fused_pack_supported(bits)):
        return _fe.minhash_pack(indices, nnz, a, b, bits=bits)
    minhash_packed.plain.add()
    return _fe.minhash_pack_plain(indices, nnz, a, b, bits=bits)


minhash_packed.plain = LaunchCount()


def oph_packed(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, k: int, bits: int, *,
               densify: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """OPH + densify/zero-code + b-bit + pack → (packed, packbits empty)."""
    if _launches(indices, "oph_pack", fused_pack_supported(bits)):
        return _fe.oph_pack(indices, nnz, a, b, k=k, bits=bits,
                            densify=densify)
    oph_packed.plain.add()
    return _fe.oph_pack_plain(indices, nnz, a, b, k=k, bits=bits,
                              densify=densify)


oph_packed.plain = LaunchCount()


def bbit_linear_packed(packed: torch.Tensor, weights: torch.Tensor, k: int,
                       bits: int, *,
                       empty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (n, C) straight from packed uint8 rows; ``empty`` (packbits,
    ``oph_zero``) drops the marked bins."""
    if _launches(packed, "bbit_linear_packed_fwd",
                 packed_kernel_supported(bits, weights.shape[1])):
        return _bl.bbit_linear_packed_fwd(packed, weights, k=k, bits=bits,
                                          empty=empty)
    bbit_linear_packed.plain.add()
    return _bl.bbit_linear_packed_fwd_plain(packed, weights, k=k, bits=bits,
                                            empty=empty)


bbit_linear_packed.plain = LaunchCount()

# the serving path's counters: kernel name -> its wrapper's launches, and
# kernel name -> the calls of its operation that took the plain version
LAUNCHES: Dict[str, LaunchCount] = {
    "minhash_pack": _fe.minhash_pack.launches,
    "oph_pack": _fe.oph_pack.launches,
    "bbit_linear_packed_fwd": _bl.bbit_linear_packed_fwd.launches,
}
PLAIN: Dict[str, LaunchCount] = {
    "minhash_pack": minhash_packed.plain,
    "oph_pack": oph_packed.plain,
    "bbit_linear_packed_fwd": bbit_linear_packed.plain,
}


def counts() -> Dict[str, int]:
    """{kernel: launches, kernel + "_plain": plain calls}."""
    out = {name: c.value for name, c in LAUNCHES.items()}
    out.update({f"{name}_plain": c.value for name, c in PLAIN.items()})
    return out


def reset_counts() -> None:
    for c in (*LAUNCHES.values(), *PLAIN.values()):
        c.reset()
