"""Dispatch between the kernels and their plain torch versions (counterpart
of ``repro/kernels/ops.py``).

Every branch here is a client of ``perf.choose`` (``perf/cost_model.py``,
``docs/DESIGN.md`` §2): the op's ``kernel`` or ``plain`` arm for the
call's shape on the tensors' device.  The eligibility of the kernel arm
is the limits of the kernels' own layouts:

  * the raw-minima encode (B3 minwise, B4 OPH, op ``encode``) takes any b
    and any k its scheme accepts (OPH: a power of two, in both versions);
  * the fused minwise encode (B1, op ``encode_packed``) packs at any b in
    [1, 16];
  * the kernels that read or write packed codes byte by byte (B2, B5,
    B6) need b ∈ ``PACK_BITS`` = {1, 2, 4, 8}, so codes never straddle a
    byte;
  * the widened linear kernels (B7, B8) take any V up to
    ``perf.BBIT_KERNEL_MAX_V`` (B8's sum: at most 65,535 blocks of 2,048
    values a bin);
  * the Hamming kernel (B10) takes packed rows of any b;
  * the VW sketch kernel (B9) needs a power-of-two m (not a cost-model
    op, as in the reference).

On a CUDA tensor the plain arm is eligible only where the kernel is not,
and on a CPU tensor only the plain arm is.  So with or without a profile
the kernel arm goes to the kernel wrapper, which launches its kernel
(counted in the wrapper's ``launches``) or raises, and every other call
runs the operation's plain torch version on the tensors' own device and
is counted in the kernel's ``PLAIN`` counter: a CPU tensor, a shape
outside eligibility (b = 6 packed for B2/B5/B6, m = 12), or the masked
widened-codes product (``bbit_linear_masked``), where the reference
itself runs plain XLA code.  On a card the ``plain`` counters of the
main path stay at zero.  Nothing here catches a kernel's failure.

Callers that know more of the shape than the tensors do (the scheme's
name and b, the model's b) pass it as ``shape``, so a profile measured
at that shape decides (``perf.dispatch_report()``'s hits); ``impl`` is
an explicit arm, ignored where it is not eligible.

``bbit_linear`` and ``bbit_linear_packed`` are ``torch.autograd.Function``s
(the reference's ``custom_vjp``s): the forward kernel (B7, B5) and, for
the gradient in the table, the dW kernel (B8, B6).  Integer inputs carry
no gradient.  B8 keeps a plan of each codes tensor it sees (see
``kernels/bbit_linear.py``); ``counts()`` shows the plans built as
``bbit_linear_bwd_dw_plans`` and the kept plans served as
``bbit_linear_bwd_dw_plan_hits``; B7's calls that walked the bins in
L2-sized slices count as ``bbit_linear_fwd_sliced``.

``counts()`` is ``obs.counts()``: these counters, registered in ``obs``
under the names below, every other counter of the program (a fit's
copies, TRON's host reads) and the spans' totals.  ``perf.choose``'s
call in ``_launches`` is the span ``dispatch.choose``.

The table may be float32 or bfloat16 (``BBitLinearConfig.param_dtype``).
The forwards give float32 logits either way, and the backwards give dW
in the table's dtype, summed in float32 first, as the reference's
``dw.astype(weights.dtype)`` does; B6 and B8 write it so themselves.
No eligibility depends on the dtype: a bfloat16 table takes the kernel
or plain arm exactly where a float32 one would.  ``counts()`` shows a
bfloat16 table's launches of B5-B8 as ``<kernel>_bf16``; their plain
calls count with the float32 ones'.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch import obs, perf
from repro_torch.kernels import _build
from repro_torch.kernels import bbit_linear as _bl
from repro_torch.kernels import fused_encode as _fe
from repro_torch.kernels import hamming as _hd
from repro_torch.kernels import minhash as _mh
from repro_torch.kernels import oph as _oph
from repro_torch.kernels import vw_sketch as _vw
from repro_torch.obs import LaunchCount

PACK_BITS = _fe.PACK_BITS
Shape = Optional[Mapping[str, object]]

# kernel name -> its wrapper's launches, and kernel name -> the calls of
# its operation that took the plain version
LAUNCHES: Dict[str, LaunchCount] = {
    "minhash": _mh.minhash.launches,
    "oph": _oph.oph.launches,
    "minhash_pack": _fe.minhash_pack.launches,
    "oph_pack": _fe.oph_pack.launches,
    "bbit_linear_packed_fwd": _bl.bbit_linear_packed_fwd.launches,
    "bbit_linear_packed_bwd_dw": _bl.bbit_linear_packed_bwd_dw.launches,
    "bbit_linear_fwd": _bl.bbit_linear_fwd.launches,
    "bbit_linear_bwd_dw": _bl.bbit_linear_bwd_dw.launches,
    "vw_sketch": _vw.vw_sketch.launches,
    "hamming_distance": _hd.hamming_distance.launches,
}
PLAIN: Dict[str, LaunchCount] = {name: LaunchCount() for name in LAUNCHES}
# the bfloat16 table instantiations of B5-B8, counted apart
LAUNCHES.update({f"{w.__name__}_bf16": w.launches_bf16 for w in (
    _bl.bbit_linear_packed_fwd, _bl.bbit_linear_packed_bwd_dw,
    _bl.bbit_linear_fwd, _bl.bbit_linear_bwd_dw)})
PLAN_BUILDS = _bl.bbit_linear_bwd_dw.plan_builds
PLAN_HITS = _bl.bbit_linear_bwd_dw.plan_hits
for _name, _count in LAUNCHES.items():
    obs.counter(_name, _count)
for _name, _count in PLAIN.items():
    obs.counter(f"{_name}_plain", _count)
obs.counter("bbit_linear_bwd_dw_plans", PLAN_BUILDS)
obs.counter("bbit_linear_bwd_dw_plan_hits", PLAN_HITS)
obs.counter("bbit_linear_fwd_sliced", _bl.bbit_linear_fwd.sliced)
obs.declare("dispatch.choose")


def counts() -> Dict[str, int]:
    """{kernel: launches, kernel + "_plain": plain calls,
    "bbit_linear_bwd_dw_plans": B8's plans built,
    "bbit_linear_bwd_dw_plan_hits": kept plans served,
    "bbit_linear_fwd_sliced": B7's calls that walked the bins in slices,
    and every other counter and span total of ``obs``}."""
    return obs.counts()


def reset_counts() -> None:
    """Every counter and span total of ``obs`` to zero."""
    obs.reset()


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def vw_kernel_supported(m_buckets: int) -> bool:
    """Whether the VW sketch kernel handles m buckets (a power of two)."""
    return _is_pow2(m_buckets)


def _launches(t: torch.Tensor, name: str, op: str, shape: Shape,
              impl: Optional[str] = None) -> bool:
    """Whether the call goes to kernel ``name``: ``perf.choose``'s arm
    of ``op`` at ``shape`` on ``t``'s device; a plain call is counted."""
    with obs.span("dispatch.choose"):
        arm = perf.choose(op, shape, device=t.device, impl=impl)
    if arm == "kernel":
        return True
    PLAIN[name].add()
    return False


def _rows_shape(indices: torch.Tensor, **keys) -> dict:
    return dict(keys, rows=int(indices.shape[0]),
                nnz=int(indices.shape[1]))


def minhash(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, *, shape: Shape = None,
            impl: Optional[str] = None) -> torch.Tensor:
    """Raw min-hashes → int32 (n, k) bits of the uint32 words (B3)."""
    shape = shape or _rows_shape(indices, scheme="minwise", k=a.shape[0])
    if _launches(indices, "minhash", "encode", shape, impl):
        return _mh.minhash(indices, nnz, a, b)
    return _mh.minhash_plain(indices, nnz, a, b)


def minhash_bbit(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, bits: int) -> torch.Tensor:
    """Min-hash + b-bit extraction → int32 (n, k) codes in [0, 2^bits)."""
    shape = _rows_shape(indices, scheme="minwise", k=a.shape[0], b=bits)
    return minhash(indices, nnz, a, b, shape=shape) & ((1 << bits) - 1)


def oph(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, k: int, *, shape: Shape = None,
        impl: Optional[str] = None) -> torch.Tensor:
    """Raw OPH bin minima → int32 (n, k) bits of the uint32 words (B4);
    empty bins hold the bits of 0xFFFFFFFF.  A k that is not a power of
    two raises, in the kernel's wrapper and in the plain version alike,
    as the reference's jnp path does."""
    shape = shape or _rows_shape(indices, scheme="oph", k=k)
    if _launches(indices, "oph", "encode", shape, impl):
        return _oph.oph(indices, nnz, a, b, k=k)
    return _oph.oph_plain(indices, nnz, a, b, k=k)


def minhash_packed(indices: torch.Tensor, nnz: torch.Tensor,
                   a: torch.Tensor, b: torch.Tensor, bits: int, *,
                   shape: Shape = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """min-hash + b-bit + pack → uint8 (n, ceil(k·bits/8)); B1 at any b
    in [1, 16]."""
    shape = shape or _rows_shape(indices, scheme="minwise", k=a.shape[0],
                                 b=bits)
    if _launches(indices, "minhash_pack", "encode_packed", shape, impl):
        return _fe.minhash_pack(indices, nnz, a, b, bits=bits)
    return _fe.minhash_pack_plain(indices, nnz, a, b, bits=bits)


def oph_packed(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, k: int, bits: int, *,
               densify: bool = True, shape: Shape = None,
               impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OPH + densify/zero-code + b-bit + pack → (packed, packbits empty)."""
    shape = shape or _rows_shape(
        indices, scheme="oph" if densify else "oph_zero", k=k, b=bits)
    if _launches(indices, "oph_pack", "encode_packed", shape, impl):
        return _fe.oph_pack(indices, nnz, a, b, k=k, bits=bits,
                            densify=densify)
    return _fe.oph_pack_plain(indices, nnz, a, b, k=k, bits=bits,
                              densify=densify)


class _BBitLinear(torch.autograd.Function):
    """logits = Σ_j W[j, codes[:, j]]; backward → dW only."""

    @staticmethod
    def forward(ctx, codes, weights, shape, impl):
        ctx.save_for_backward(codes)
        ctx.vsize, ctx.dtype = weights.shape[1], weights.dtype
        if _launches(codes, "bbit_linear_fwd", "logits", shape, impl):
            return _bl.bbit_linear_fwd(codes, weights)
        return _bl.bbit_linear_fwd_plain(codes, weights)

    @staticmethod
    def backward(ctx, dout):
        (codes,) = ctx.saved_tensors
        dout = dout.to(torch.float32).contiguous()
        shape = {"v": ctx.vsize, "k": int(codes.shape[1]),
                 "rows": int(codes.shape[0])}
        if _launches(codes, "bbit_linear_bwd_dw", "logits_bwd", shape):
            dw = _bl.bbit_linear_bwd_dw(codes, dout, ctx.vsize, ctx.dtype)
        else:
            dw = _bl.bbit_linear_bwd_dw_plain(codes, dout, ctx.vsize,
                                              dtype=ctx.dtype)
        return None, dw, None, None


def bbit_linear(codes: torch.Tensor, weights: torch.Tensor, *,
                shape: Shape = None,
                impl: Optional[str] = None) -> torch.Tensor:
    """logits (n, C) = Σ_j W[j, codes[n, j], :] from integer codes (n, k)
    in [0, V) — differentiable in W (B7 forward, B8 backward)."""
    if codes.dtype != torch.int32:
        codes = codes.to(torch.int32)
    shape = shape or {"k": int(codes.shape[1]), "v": int(weights.shape[1]),
                      "rows": int(codes.shape[0])}
    return _BBitLinear.apply(codes.contiguous(), weights, shape, impl)


class _BBitLinearMasked(torch.autograd.Function):
    """Masked widened-codes logits, plain torch in both directions."""

    @staticmethod
    def forward(ctx, codes, empty, weights):
        ctx.save_for_backward(codes, empty)
        ctx.vsize, ctx.dtype = weights.shape[1], weights.dtype
        PLAIN["bbit_linear_fwd"].add()
        return _bl.bbit_linear_fwd_plain(codes, weights, empty)

    @staticmethod
    def backward(ctx, dout):
        codes, empty = ctx.saved_tensors
        PLAIN["bbit_linear_bwd_dw"].add()
        return None, None, _bl.bbit_linear_bwd_dw_plain(
            codes, dout.to(torch.float32), ctx.vsize, empty, dtype=ctx.dtype)


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
    def forward(ctx, packed, empty, weights, k, bits, shape, impl):
        ctx.save_for_backward(packed, empty)
        ctx.k, ctx.bits, ctx.vsize = k, bits, weights.shape[1]
        ctx.dtype = weights.dtype
        if _launches(packed, "bbit_linear_packed_fwd", "logits_packed",
                     shape, impl):
            return _bl.bbit_linear_packed_fwd(packed, weights, k=k,
                                              bits=bits, empty=empty)
        return _bl.bbit_linear_packed_fwd_plain(packed, weights, k=k,
                                                bits=bits, empty=empty)

    @staticmethod
    def backward(ctx, dout):
        packed, empty = ctx.saved_tensors
        dout = dout.to(torch.float32).contiguous()
        kw = dict(k=ctx.k, bits=ctx.bits, empty=empty)
        shape = {"v": ctx.vsize, "k": ctx.k, "b": ctx.bits,
                 "rows": int(packed.shape[0])}
        if _launches(packed, "bbit_linear_packed_bwd_dw",
                     "logits_packed_bwd", shape):
            dw = _bl.bbit_linear_packed_bwd_dw(packed, dout, ctx.vsize,
                                               dtype=ctx.dtype, **kw)
        else:
            dw = _bl.bbit_linear_packed_bwd_dw_plain(
                packed, dout, ctx.vsize, dtype=ctx.dtype, **kw)
        return None, None, dw, None, None, None, None


def bbit_linear_packed(packed: torch.Tensor, weights: torch.Tensor, k: int,
                       bits: int, *,
                       empty: Optional[torch.Tensor] = None,
                       shape: Shape = None,
                       impl: Optional[str] = None) -> torch.Tensor:
    """logits (n, C) straight from packed uint8 rows — differentiable in
    W (B5 forward, B6 backward); ``empty`` (packbits, ``oph_zero``) drops
    the marked bins in both directions."""
    shape = shape or {"k": k, "b": bits, "v": int(weights.shape[1]),
                      "rows": int(packed.shape[0])}
    return _BBitLinearPacked.apply(packed, empty, weights, k, bits, shape,
                                   impl)


def vw_sketch(indices: torch.Tensor, values: torch.Tensor,
              nnz: torch.Tensor, m_buckets: int,
              seed: int = 0) -> torch.Tensor:
    """f32 (n, m) VW sketches: the kernel for a power-of-two m, the plain
    version otherwise.  Like the reference's ``ops.vw_sketch``, both take
    bucket = h & (m − 1), which for another m is not ``core.vw``'s
    h mod m."""
    if (not _build.on_cpu("vw_sketch", indices)
            and vw_kernel_supported(m_buckets)):
        return _vw.vw_sketch(indices, values, nnz, m_buckets, seed)
    PLAIN["vw_sketch"].add()
    return _vw.vw_sketch_plain(indices, values, nnz, m_buckets, seed)


def hamming_topk(query: torch.Tensor, cands: torch.Tensor, *, k: int,
                 bits: int, topk: int, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``topk`` candidates by packed-code Hamming similarity.

    ``query`` uint8 (w,), ``cands`` uint8 (n, w): packed b-bit code rows
    (w = ceil(k·bits/8)), on one device.  → (idx int32 (t,), sims
    float32 (t,)), t = min(topk, n), sims descending: sim = 1 −
    dist/(k·bits).  The distances are B10 (any b: it popcounts whole
    bytes, and both rows pad their last byte with zeros) or, on the CPU,
    its plain version; top-k is a stable ascending sort of the distances,
    so equal distances keep the lower index first, as ``jax.lax.top_k``
    does, and the sims are computed in float32 as the reference does.
    """
    shape = {"b": int(bits), "k": int(k), "rows": int(cands.shape[0]),
             "width": int(cands.shape[1])}
    if _launches(cands, "hamming_distance", "hamming_topk", shape, impl):
        dist = _hd.hamming_distance(query, cands)
    else:
        dist = _hd.hamming_distance_plain(query, cands)
    t = min(int(topk), int(cands.shape[0]))
    idx = torch.sort(dist, stable=True).indices[:t]
    neg = (-dist[idx]).to(torch.float32)
    # a tensor divisor: CUDA torch divides by a Python scalar through its
    # reciprocal, which can round differently
    sims = 1.0 + neg / torch.full_like(neg, float(k * bits))
    return idx.to(torch.int32), sims
