"""Dispatch between the kernels and their plain torch versions (counterpart
of ``repro/kernels/ops.py``).

The eligibility predicates are the reference's static rules:

  * fused encode (B1, B2) needs b ∈ {1, 2, 4, 8}, so codes never
    straddle a byte (``fused_pack_supported``);
  * the packed linear kernels (B5, B6) also need 2^b ≤
    ``BBIT_KERNEL_MAX_V`` (``packed_kernel_supported``);
  * the widened linear kernels (B7, B8) need V ≤ ``BBIT_KERNEL_MAX_V``
    (``linear_kernel_supported``);
  * the VW sketch kernel (B9) needs a power-of-two m.

Inside eligibility a call on a CUDA tensor goes to the kernel wrapper,
which launches its kernel (counted in the wrapper's ``launches``) or
raises.  Every other call runs the operation's plain torch version on
the tensors' own device and is counted in the kernel's ``PLAIN``
counter: a CPU tensor, a shape outside eligibility (b = 6, b = 16,
m = 12, …), or the masked widened-codes product (``bbit_linear_masked``),
where the reference itself runs plain XLA code.  So on a
card the ``plain`` counters of the main path stay at zero.  Nothing
here catches a kernel's failure.

``bbit_linear`` and ``bbit_linear_packed`` are ``torch.autograd.Function``s
(the reference's ``custom_vjp``s): the forward kernel (B7, B5) and, for
the gradient in the table, the dW kernel (B8, B6).  Integer inputs carry
no gradient.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bbit_linear as _bl
from repro_torch.kernels import fused_encode as _fe
from repro_torch.kernels import vw_sketch as _vw
from repro_torch.kernels.counters import LaunchCount

PACK_BITS = _fe.PACK_BITS
BBIT_KERNEL_MAX_V = 4096

# kernel name -> its wrapper's launches, and kernel name -> the calls of
# its operation that took the plain version
LAUNCHES: Dict[str, LaunchCount] = {
    "minhash_pack": _fe.minhash_pack.launches,
    "oph_pack": _fe.oph_pack.launches,
    "bbit_linear_packed_fwd": _bl.bbit_linear_packed_fwd.launches,
    "bbit_linear_packed_bwd_dw": _bl.bbit_linear_packed_bwd_dw.launches,
    "bbit_linear_fwd": _bl.bbit_linear_fwd.launches,
    "bbit_linear_bwd_dw": _bl.bbit_linear_bwd_dw.launches,
    "vw_sketch": _vw.vw_sketch.launches,
}
PLAIN: Dict[str, LaunchCount] = {name: LaunchCount() for name in LAUNCHES}


def counts() -> Dict[str, int]:
    """{kernel: launches, kernel + "_plain": plain calls}."""
    out = {name: c.value for name, c in LAUNCHES.items()}
    out.update({f"{name}_plain": c.value for name, c in PLAIN.items()})
    return out


def reset_counts() -> None:
    for c in (*LAUNCHES.values(), *PLAIN.values()):
        c.reset()


def fused_pack_supported(bits: int) -> bool:
    """Whether the fused hash→b-bit→pack kernels handle b=bits."""
    return bits in PACK_BITS


def packed_kernel_supported(bits: int, v: int) -> bool:
    """Whether the packed-input linear kernels handle (b=bits, V=v)."""
    return bits in PACK_BITS and v <= BBIT_KERNEL_MAX_V


def linear_kernel_supported(v: int) -> bool:
    """Whether the widened-code linear kernels handle a table of V=v."""
    return v <= BBIT_KERNEL_MAX_V


def vw_kernel_supported(m_buckets: int) -> bool:
    """Whether the VW sketch kernel handles m buckets (a power of two)."""
    return m_buckets >= 1 and m_buckets & (m_buckets - 1) == 0


def _launches(t: torch.Tensor, name: str, eligible: bool) -> bool:
    """Whether the call goes to kernel ``name``: eligible and on a card;
    otherwise the plain call is counted."""
    if eligible and not _build.on_cpu(name, t):
        return True
    PLAIN[name].add()
    return False


def minhash_packed(indices: torch.Tensor, nnz: torch.Tensor,
                   a: torch.Tensor, b: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """min-hash + b-bit + pack → uint8 (n, ceil(k·bits/8))."""
    if _launches(indices, "minhash_pack", fused_pack_supported(bits)):
        return _fe.minhash_pack(indices, nnz, a, b, bits=bits)
    return _fe.minhash_pack_plain(indices, nnz, a, b, bits=bits)


def oph_packed(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, k: int, bits: int, *,
               densify: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """OPH + densify/zero-code + b-bit + pack → (packed, packbits empty)."""
    if _launches(indices, "oph_pack", fused_pack_supported(bits)):
        return _fe.oph_pack(indices, nnz, a, b, k=k, bits=bits,
                            densify=densify)
    return _fe.oph_pack_plain(indices, nnz, a, b, k=k, bits=bits,
                              densify=densify)


class _BBitLinear(torch.autograd.Function):
    """logits = Σ_j W[j, codes[:, j]]; backward → dW only."""

    @staticmethod
    def forward(ctx, codes, weights):
        ctx.save_for_backward(codes)
        ctx.vsize = weights.shape[1]
        if _launches(codes, "bbit_linear_fwd",
                     linear_kernel_supported(weights.shape[1])):
            return _bl.bbit_linear_fwd(codes, weights)
        return _bl.bbit_linear_fwd_plain(codes, weights)

    @staticmethod
    def backward(ctx, dout):
        (codes,) = ctx.saved_tensors
        dout = dout.to(torch.float32).contiguous()
        if _launches(codes, "bbit_linear_bwd_dw",
                     linear_kernel_supported(ctx.vsize)):
            return None, _bl.bbit_linear_bwd_dw(codes, dout, ctx.vsize)
        return None, _bl.bbit_linear_bwd_dw_plain(codes, dout, ctx.vsize)


def bbit_linear(codes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """logits (n, C) = Σ_j W[j, codes[n, j], :] from integer codes (n, k)
    in [0, V) — differentiable in W (B7 forward, B8 backward)."""
    if codes.dtype != torch.int32:
        codes = codes.to(torch.int32)
    return _BBitLinear.apply(codes.contiguous(), weights)


class _BBitLinearMasked(torch.autograd.Function):
    """Masked widened-codes logits, plain torch in both directions."""

    @staticmethod
    def forward(ctx, codes, empty, weights):
        ctx.save_for_backward(codes, empty)
        ctx.vsize = weights.shape[1]
        PLAIN["bbit_linear_fwd"].add()
        return _bl.bbit_linear_fwd_plain(codes, weights, empty)

    @staticmethod
    def backward(ctx, dout):
        codes, empty = ctx.saved_tensors
        PLAIN["bbit_linear_bwd_dw"].add()
        return None, None, _bl.bbit_linear_bwd_dw_plain(
            codes, dout.to(torch.float32), ctx.vsize, empty)


def bbit_linear_masked(codes: torch.Tensor, weights: torch.Tensor,
                       empty: torch.Tensor) -> torch.Tensor:
    """``bbit_linear`` without the bins marked in bool ``empty`` (n, k)
    (zero-coded OPH), differentiable in W.  The reference runs this as
    a plain gather, with no kernel, and so does the port: every call
    counts on the ``bbit_linear_fwd`` / ``bbit_linear_bwd_dw`` plain
    counters, on any device."""
    return _BBitLinearMasked.apply(codes, empty, weights)


class _BBitLinearPacked(torch.autograd.Function):
    """Packed-rows logits; backward → dW only, empty bins excluded."""

    @staticmethod
    def forward(ctx, packed, empty, weights, k, bits):
        ctx.save_for_backward(packed, empty)
        ctx.k, ctx.bits, ctx.vsize = k, bits, weights.shape[1]
        if _launches(packed, "bbit_linear_packed_fwd",
                     packed_kernel_supported(bits, weights.shape[1])):
            return _bl.bbit_linear_packed_fwd(packed, weights, k=k,
                                              bits=bits, empty=empty)
        return _bl.bbit_linear_packed_fwd_plain(packed, weights, k=k,
                                                bits=bits, empty=empty)

    @staticmethod
    def backward(ctx, dout):
        packed, empty = ctx.saved_tensors
        dout = dout.to(torch.float32).contiguous()
        kw = dict(k=ctx.k, bits=ctx.bits, empty=empty)
        if _launches(packed, "bbit_linear_packed_bwd_dw",
                     packed_kernel_supported(ctx.bits, ctx.vsize)):
            dw = _bl.bbit_linear_packed_bwd_dw(packed, dout, ctx.vsize, **kw)
        else:
            dw = _bl.bbit_linear_packed_bwd_dw_plain(packed, dout,
                                                     ctx.vsize, **kw)
        return None, None, dw, None, None


def bbit_linear_packed(packed: torch.Tensor, weights: torch.Tensor, k: int,
                       bits: int, *,
                       empty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (n, C) straight from packed uint8 rows — differentiable in
    W (B5 forward, B6 backward); ``empty`` (packbits, ``oph_zero``) drops
    the marked bins in both directions."""
    return _BBitLinearPacked.apply(packed, empty, weights, k, bits)


def vw_sketch(indices: torch.Tensor, values: torch.Tensor,
              nnz: torch.Tensor, m_buckets: int,
              seed: int = 0) -> torch.Tensor:
    """f32 (n, m) VW sketches: the kernel for a power-of-two m, the plain
    version otherwise.  Like the reference's ``ops.vw_sketch``, both take
    bucket = h & (m − 1), which for another m is not ``core.vw``'s
    h mod m."""
    if _launches(indices, "vw_sketch", vw_kernel_supported(m_buckets)):
        return _vw.vw_sketch(indices, values, nnz, m_buckets, seed)
    return _vw.vw_sketch_plain(indices, values, nnz, m_buckets, seed)
