"""b-bit linear layer kernels and their plain versions (counterpart of
``repro/kernels/bbit_linear.py``).

    forward:  logits[n, c] = Σ_j W[j, code(n, j), c]
    backward: dW[j, v, c]  = Σ_n 1{code(n, j) = v} · dout[n, c]

from widened int32 (n, k) codes (B7 ``bbit_linear_fwd``, B8
``bbit_linear_bwd_dw``) or straight from packed uint8 rows in the
``core.bbit`` layout (B5 ``bbit_linear_packed_fwd``, B6
``bbit_linear_packed_bwd_dw``), where an optional packbits empty mask
(``oph_zero``) drops the marked bins.  A widened code outside [0, V)
adds nothing, as in the reference's kernels.  Each wrapper launches its
CUDA kernel of ``csrc/bbit_linear.cu`` on CUDA tensors and takes the
plain version on CPU tensors.

The table is float32 or bfloat16 (``TABLE_DTYPES``).  The forwards read
a bfloat16 table in place, widen each value to float32 (exact) and sum
in float32, so their logits are float32 and equal the same kernel's on
the table widened.  The dW wrappers take ``dtype``, dW's type: float32,
or bfloat16 for a bfloat16 table, the float32 sums rounded to nearest
even as torch's ``.to(torch.bfloat16)`` rounds them (the reference's
``dw.astype(weights.dtype)``); so do their plain versions.  A launch
counts on the wrapper's ``launches`` or, at bfloat16, its
``launches_bf16``.  The kernels sum in another order than torch, so the
two agree to float32 rounding (allclose), not bit for bit; the kernels themselves sum in a fixed order, with no float atomics,
and give the same bits on every run.

B8 works from a plan of its codes: for each bin j, the rows whose code
lies in [0, V), ordered by (code, row) (``bbit_linear_dw_plan``,
``DwPlan``), after which each call sums runs of dout
(``bbit_linear_dw_sum``).  TRON calls B8 about 51 times a fit on the
same training codes, so the wrapper keeps the plans of the last
``DW_PLAN_CACHE_ENTRIES`` codes tensors it saw (``_DwPlanCache``):
8·n·k + 1,028·k bytes each (two int32 (k, n) tensors and 257 offsets a
bin; 64.5 MB at 16,000 × 500 codes), and 8·n·k more of scratch while a
plan with more than one radix pass (V > 256) is built.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bbit import (packed_mask_width, packed_width,
                                   unpack_codes_torch, unpack_mask_torch)
from repro_torch.kernels import _build
from repro_torch.obs import LaunchCount
from repro_torch.kernels.fused_encode import check_bits

# B7: bins a thread gathers at once (csrc kFwdChunk), and the bytes of
# a 32-bin slice of the table that still fit L1 beside other blocks; the
# share of the card's L2 that a bin slice's part of the table may take,
# and the times a call must gather each table value before slices pay
FWD_CHUNK = 32
FWD_L1_SLICE_BYTES = 64 << 10
FWD_L2_SHARE = 1 / 6
FWD_SLICE_REUSE = 1.75
# B8: the plans kept; the entries a sum block aims at (four windows of
# csrc kSumWindow) and its values at most (kSumMaxSpan)
DW_PLAN_CACHE_ENTRIES = 4
DW_SUM_TARGET_ENTRIES = 8192
DW_SUM_MAX_SPAN = 2048
MAX_GRID_Y = 65535
# B6: bins a block (csrc kDwBins), rows a group (8 steps of 4), the warps
# a block takes, and blocks a cluster along the rows at most (kDwMaxParts);
# scripts/sweep_bbit_linear.py times each at the packed gradient's shapes.
# No card property enters the choice, so dW's order of sums is the same on
# every card
PACKED_DW_BINS = 8
PACKED_DW_ROWS = 32
PACKED_DW_WARPS = 4
PACKED_DW_MAX_PARTS = 8
# B5: rows (one warp each) a block, at most (csrc kPackedFwdMaxRows), and
# the blocks an SM is given before a block takes more rows
PACKED_FWD_MAX_ROWS = 8
PACKED_FWD_BLOCKS_PER_SM = 8
# the table types B5/B7 read and B6/B8 write dW in
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _kept(codes: torch.Tensor, vsize: int) -> torch.Tensor:
    """Bool mask of the codes in [0, V): the ones that add anything."""
    return (codes >= 0) & (codes < vsize)


def gather_sum(codes: torch.Tensor, weights: torch.Tensor,
                empty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_j W[j, codes[:, j], :] over the bins not marked in bool
    ``empty`` (n, k) whose code lies in [0, V), in torch ops
    (differentiable in W)."""
    v = weights.shape[1]
    codes = codes.to(torch.int64)
    drop = ~_kept(codes, v)
    if empty is not None:
        drop = drop | empty
    j = torch.arange(codes.shape[1], device=codes.device)
    gathered = weights[j[None, :], codes.clamp(0, v - 1)].to(torch.float32)
    return gathered.masked_fill(drop[:, :, None], 0.0).sum(dim=1)


def _histogram(codes: torch.Tensor, dout: torch.Tensor, vsize: int,
               empty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW (k, V, C): ``dout`` rows added into the bins their codes pick,
    skipping codes outside [0, V) and the bins marked in bool ``empty``
    (n, k), in torch ops."""
    n, k = codes.shape
    c = dout.shape[1]
    codes = codes.to(torch.int64)
    drop = ~_kept(codes, vsize)
    if empty is not None:
        drop = drop | empty
    flat = (torch.arange(k, device=codes.device) * vsize)[None, :] \
        + codes.clamp(0, vsize - 1)
    rows = dout.to(torch.float32)[:, None, :].expand(n, k, c)
    rows = rows.masked_fill(drop[:, :, None], 0.0)
    dw = torch.zeros((k * vsize, c), dtype=torch.float32, device=codes.device)
    dw.index_add_(0, flat.reshape(-1), rows.reshape(n * k, c))
    return dw.view(k, vsize, c)


def fwd_layout(k: int, v: int, c: int) -> int:
    """B7's bins per group for a (k, V, C) table, from the shapes alone:
    32 where a 32-bin slice of the table fits L1 (``FWD_L1_SLICE_BYTES``),
    so that the blocks resident on an SM share one slice; else all k in
    one group, which needs no second pass (walked in bin slices where
    ``fwd_slices`` says so)."""
    if FWD_CHUNK * 4 * v * c <= FWD_L1_SLICE_BYTES:
        return FWD_CHUNK
    return max(k, 1)


def fwd_slices(n: int, k: int, v: int, c: int, itemsize: int,
               l2_bytes: int) -> int:
    """B7's bins a slice for n rows over a (k, V, C) table of
    ``itemsize``-byte values on a card with ``l2_bytes`` of L2, from these
    alone: k (one pass) on the L1 path (``fwd_layout``'s 32-bin groups),
    where the whole table fits ``FWD_L2_SHARE`` of the L2, or where the
    rows gather each table value fewer than ``FWD_SLICE_REUSE`` times
    (nearly every miss is then a first touch); else the most bins, a
    multiple of ``FWD_CHUNK`` and at least one chunk, whose part of the
    table fits that share.  Slices end on chunk boundaries, so a row's
    logits are the same bits at any width."""
    k1 = max(k, 1)
    per_bin = v * c * itemsize
    budget = int(l2_bytes * FWD_L2_SHARE)
    if (fwd_layout(k, v, c) < k1 or k * per_bin <= budget
            or n < FWD_SLICE_REUSE * v):
        return k1
    return min(max(budget // per_bin // FWD_CHUNK, 1) * FWD_CHUNK, k1)


def bbit_linear_fwd_plain(codes: torch.Tensor, weights: torch.Tensor,
                          empty: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """B7's plain version (``ref.bbit_linear_fwd``): gather → sum; bool
    ``empty`` (n, k) drops the marked bins, as the reference's masked
    gather in ``bbit_logits`` does."""
    return gather_sum(codes, weights, empty)


def bbit_linear_fwd_grouped_plain(codes: torch.Tensor,
                                  weights: torch.Tensor) -> torch.Tensor:
    """B7's order of sums in torch ops: the partial logits of each bin
    group of ``fwd_layout``, added in group order."""
    k = codes.shape[1]
    group = fwd_layout(k, weights.shape[1], weights.shape[2])
    out = None
    for j0 in range(0, max(k, 1), group):
        part = gather_sum(codes[:, j0:j0 + group], weights[j0:j0 + group])
        out = part if out is None else out + part
    return out


def bbit_linear_bwd_dw_plain(codes: torch.Tensor, dout: torch.Tensor,
                             vsize: int,
                             empty: Optional[torch.Tensor] = None, *,
                             dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """B8's plain version (``ref.bbit_linear_bwd_dw``); bool ``empty``
    (n, k) drops the marked bins; the float32 sums cast to ``dtype``."""
    return _histogram(codes, dout, vsize, empty).to(dtype)


def dw_plan_passes(vsize: int) -> int:
    """Radix passes of 8 bits that B8's plan takes to sort codes in
    [0, V): one for V ≤ 256, two for V ≤ 65536."""
    return max(1, -(-max(vsize - 1, 0).bit_length() // 8))


def dw_sum_span(n: int, vsize: int) -> int:
    """Values of dW a block of B8's sum owns: the power of two nearest
    below ``DW_SUM_TARGET_ENTRIES``·V/n (about that many entries), within
    [32, ``DW_SUM_MAX_SPAN``] and at most V."""
    want = max(DW_SUM_TARGET_ENTRIES * vsize // max(n, 1), 1)
    span = 1 << (want.bit_length() - 1)
    return max(1, min(vsize, DW_SUM_MAX_SPAN, max(32, span)))


class DwPlan(NamedTuple):
    """B8's plan of int32 codes (n, k), for a table of V values.  Row j
    of ``perm`` (int32 (k, n)) holds the rows whose code of bin j lies
    in [0, V), ordered by (code, row), then -1; row j of ``scode`` their
    codes, then V; row j of ``offsets`` (int32 (k, 257)) where each
    value d of the last radix digit (code >> 8·(passes − 1)) starts
    among them, and at 256 their count."""
    perm: torch.Tensor
    scode: torch.Tensor
    offsets: torch.Tensor


def bbit_linear_dw_plan_plain(codes: torch.Tensor, vsize: int) -> DwPlan:
    """B8's plan in torch ops (``DwPlan``)."""
    keys = codes.to(torch.int64).t()
    keys = torch.where(_kept(keys, vsize), keys, vsize)
    scode, order = torch.sort(keys, dim=1, stable=True)
    kept = scode < vsize
    shift = 8 * (dw_plan_passes(vsize) - 1)
    digits = torch.where(kept, scode >> shift, 256).contiguous()
    bounds = torch.arange(257, device=codes.device).expand(
        digits.shape[0], 257).contiguous()
    offsets = torch.searchsorted(digits, bounds)
    return DwPlan(torch.where(kept, order, -1).to(torch.int32).contiguous(),
                  scode.to(torch.int32).contiguous(),
                  offsets.to(torch.int32))


def bbit_linear_dw_sum_plain(plan: DwPlan, dout: torch.Tensor,
                             vsize: int) -> torch.Tensor:
    """B8's sum over a plan in torch ops: dW f32 (k, V, C)."""
    k = plan.perm.shape[0]
    c = dout.shape[1]
    kept = plan.scode < vsize
    dev = plan.perm.device
    flat = ((torch.arange(k, device=dev) * vsize)[:, None]
            + plan.scode.to(torch.int64))[kept]
    rows = dout.to(torch.float32)[plan.perm.to(torch.int64)[kept]]
    dw = torch.zeros((k * vsize, c), dtype=torch.float32, device=dev)
    dw.index_add_(0, flat, rows)
    return dw.view(k, vsize, c)


class _DwPlanCache:
    """B8's plans by codes tensor, at most ``entries`` of them, the least
    recently used dropped first.  An entry holds a weak reference to its
    codes tensor and goes when the tensor dies; it serves only that same
    tensor object, at the same ``_version`` (no in-place write since),
    data pointer, shape and device, and the same V.  ``get`` builds a
    missing plan with ``build(codes, vsize)`` and counts it in
    ``builds``, and counts a kept plan it serves in ``hits``."""

    def __init__(self, entries: int, builds: Optional[LaunchCount] = None):
        self.entries = entries
        self.builds = LaunchCount() if builds is None else builds
        self.hits = LaunchCount()
        self._plans: "OrderedDict[int, tuple]" = OrderedDict()
        self._lock = threading.RLock()   # a weakref callback may re-enter

    @staticmethod
    def _stamp(codes: torch.Tensor, vsize: int) -> tuple:
        return (codes._version, codes.data_ptr(), tuple(codes.shape),
                codes.device, vsize)

    def get(self, codes: torch.Tensor, vsize: int,
            build: Callable[[torch.Tensor, int], DwPlan]) -> DwPlan:
        key, stamp = id(codes), self._stamp(codes, vsize)
        with self._lock:
            hit = self._plans.get(key)
            if hit is not None and hit[0]() is codes and hit[1] == stamp:
                self._plans.move_to_end(key)
                self.hits.add()
                return hit[2]
        plan = build(codes, vsize)
        self.builds.add()
        ref = weakref.ref(codes, lambda r, key=key: self._drop(key, r))
        with self._lock:
            self._plans[key] = (ref, stamp, plan)
            self._plans.move_to_end(key)
            while len(self._plans) > self.entries:
                self._plans.popitem(last=False)
        return plan

    def _drop(self, key: int, ref) -> None:
        with self._lock:
            hit = self._plans.get(key)
            if hit is not None and hit[0] is ref:
                del self._plans[key]

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()

    def __len__(self) -> int:
        return len(self._plans)


_DW_PLANS = _DwPlanCache(DW_PLAN_CACHE_ENTRIES)


def bbit_linear_packed_fwd_plain(packed: torch.Tensor,
                                 weights: torch.Tensor, *, k: int, bits: int,
                                 empty: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """B5's plain version (``ref.bbit_linear_packed_fwd``): unpack →
    gather → mask → sum, for any b."""
    return gather_sum(unpack_codes_torch(packed, k, bits), weights,
                       None if empty is None else unpack_mask_torch(empty, k))


def bbit_linear_packed_bwd_dw_plain(packed: torch.Tensor, dout: torch.Tensor,
                                    vsize: int, *, k: int, bits: int,
                                    empty: Optional[torch.Tensor] = None,
                                    dtype: torch.dtype = torch.float32
                                    ) -> torch.Tensor:
    """B6's plain version (``ref.bbit_linear_packed_bwd_dw``); the
    float32 sums cast to ``dtype``."""
    return _histogram(unpack_codes_torch(packed, k, bits), dout, vsize,
                      None if empty is None else unpack_mask_torch(empty, k)
                      ).to(dtype)


def _check_same_device(what: str, first: torch.Tensor, *rest) -> None:
    for t in (first, *rest):
        if t is not None and (t.device != first.device
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: inputs must be contiguous and on "
                             f"{first.device}")


def _check_table(what: str, weights: torch.Tensor, k: int, min_v: int):
    if (weights.dtype not in TABLE_DTYPES or weights.dim() != 3
            or weights.shape[0] != k or weights.shape[1] < min_v):
        raise ValueError(f"{what}: weights must be float32 or bfloat16 "
                         f"(k={k}, V>={min_v}, C), got {weights.dtype} "
                         f"{tuple(weights.shape)}")


def _check_dtype(what: str, dtype: torch.dtype) -> None:
    if dtype not in TABLE_DTYPES:
        raise ValueError(f"{what}: dW is float32 or bfloat16, not {dtype}")


def _count(wrapper, dtype: torch.dtype) -> None:
    """One launch of ``wrapper``'s kernel at table type ``dtype``."""
    (wrapper.launches_bf16 if dtype == torch.bfloat16
     else wrapper.launches).add()


def _check_dout(what: str, dout: torch.Tensor, n: int) -> None:
    if dout.dtype != torch.float32 or dout.dim() != 2 or dout.shape[0] != n:
        raise ValueError(f"{what}: dout must be float32 ({n}, C), got "
                         f"{dout.dtype} {tuple(dout.shape)}")


def _check_packed(what: str, packed: torch.Tensor, k: int, bits: int,
                  empty: Optional[torch.Tensor]) -> None:
    n = packed.shape[0]
    if packed.dtype != torch.uint8 or packed.shape != (n, packed_width(k, bits)):
        raise ValueError(f"{what}: packed must be uint8 (n, "
                         f"{packed_width(k, bits)}), got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if empty is not None and (empty.dtype != torch.uint8 or empty.shape
                              != (n, packed_mask_width(k))):
        raise ValueError(f"{what}: empty must be uint8 (n, "
                         f"{packed_mask_width(k)}), got {empty.dtype} "
                         f"{tuple(empty.shape)}")


def _check_codes(what: str, codes: torch.Tensor) -> None:
    if codes.dtype != torch.int32 or codes.dim() != 2:
        raise ValueError(f"{what}: codes must be int32 (n, k), got "
                         f"{codes.dtype} {tuple(codes.shape)}")


def _fwd_launch(codes: torch.Tensor, weights: torch.Tensor, group: int,
                width: int) -> torch.Tensor:
    """Launches B7 with ``group`` bins per group (``fwd_layout``'s, on
    the main path) and, in one group, ``width`` bins a slice
    (``fwd_slices``'; k: one pass)."""
    n, k = codes.shape
    v, c = weights.shape[1], weights.shape[2]
    groups = -(-k // group)
    if groups > MAX_GRID_Y:
        raise ValueError(f"bbit_linear_fwd: {groups} bin groups, more than "
                         f"{MAX_GRID_Y}")
    out = torch.empty((n, c), dtype=torch.float32, device=codes.device)
    part = (torch.empty((groups, n, c), dtype=torch.float32,
                        device=codes.device) if groups > 1 else out)
    vec = k % 4 == 0 and codes.data_ptr() % 16 == 0
    lib = _build.load("bbit_linear")
    with torch.cuda.device(codes.device):
        code = lib.repro_bbit_linear_fwd(
            codes.data_ptr(), weights.data_ptr(), part.data_ptr(),
            out.data_ptr(), n, k, v, c, group, width, int(vec),
            int(weights.dtype == torch.bfloat16), codes.device.index,
            _build.stream(codes))
    _build.check("bbit_linear", code, "bbit_linear_fwd")
    return out


def bbit_linear_fwd(codes: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """B7: logits f32 (n, C) from int32 codes (n, k) and a table f32 or
    bf16 (k, V, C); codes outside [0, V) add nothing.  A call that walks
    the bins in slices (``fwd_slices``) counts on ``sliced`` too."""
    if _build.on_cpu("bbit_linear_fwd", codes):
        return bbit_linear_fwd_plain(codes, weights)
    _check_codes("bbit_linear_fwd", codes)
    n, k = codes.shape
    _check_table("bbit_linear_fwd", weights, k, 1)
    _check_same_device("bbit_linear_fwd", codes, weights)
    v, c = weights.shape[1], weights.shape[2]
    width = fwd_slices(n, k, v, c, weights.element_size(),
                       _build.l2_bytes(codes.device.index))
    out = _fwd_launch(codes, weights, fwd_layout(k, v, c), width)
    _count(bbit_linear_fwd, weights.dtype)
    if width < k:
        bbit_linear_fwd.sliced.add()
    return out


bbit_linear_fwd.launches = LaunchCount()
bbit_linear_fwd.launches_bf16 = LaunchCount()
bbit_linear_fwd.sliced = LaunchCount()


def bbit_linear_dw_plan(codes: torch.Tensor, vsize: int) -> DwPlan:
    """B8's plan of int32 codes (n, k) (``DwPlan``), built by the plan
    kernel (a stable radix sort of each bin's rows by code) on a CUDA
    tensor."""
    if _build.on_cpu("bbit_linear_dw_plan", codes):
        return bbit_linear_dw_plan_plain(codes, vsize)
    _check_codes("bbit_linear_dw_plan", codes)
    _check_same_device("bbit_linear_dw_plan", codes)
    if vsize < 1:
        raise ValueError(f"bbit_linear_dw_plan: vsize {vsize} < 1")
    n, k = codes.shape
    dev = codes.device
    passes = dw_plan_passes(vsize)
    plan = DwPlan(torch.empty((k, n), dtype=torch.int32, device=dev),
                  torch.empty((k, n), dtype=torch.int32, device=dev),
                  torch.empty((k, 257), dtype=torch.int32, device=dev))
    count = torch.empty((k,), dtype=torch.int32, device=dev)
    tmp = (torch.empty((2, k, n), dtype=torch.int32, device=dev)
           if passes > 1 else None)
    lib = _build.load("bbit_linear")
    with torch.cuda.device(dev):
        code = lib.repro_bbit_linear_dw_plan(
            codes.data_ptr(), None if tmp is None else tmp[0].data_ptr(),
            None if tmp is None else tmp[1].data_ptr(), count.data_ptr(),
            plan.scode.data_ptr(), plan.perm.data_ptr(),
            plan.offsets.data_ptr(), n, k, vsize, passes, dev.index,
            _build.stream(codes))
    _build.check("bbit_linear", code, "bbit_linear_dw_plan")
    return plan


def bbit_linear_dw_sum(plan: DwPlan, dout: torch.Tensor, vsize: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B8's sum over a plan: dW (k, V, C) in ``dtype`` from a ``DwPlan``
    and dout f32 (n, C); each launch counts on ``bbit_linear_bwd_dw``'s
    counter of ``dtype``."""
    _check_dtype("bbit_linear_dw_sum", dtype)
    if _build.on_cpu("bbit_linear_dw_sum", plan.perm):
        return bbit_linear_dw_sum_plain(plan, dout, vsize).to(dtype)
    k, n = plan.perm.shape
    if (any(t.dtype != torch.int32 for t in plan)
            or plan.scode.shape != plan.perm.shape
            or plan.offsets.shape != (k, 257)):
        raise ValueError("bbit_linear_dw_sum: a plan is int32 perm and "
                         "scode (k, n) and offsets (k, 257), got "
                         f"{[(t.dtype, tuple(t.shape)) for t in plan]}")
    _check_dout("bbit_linear_dw_sum", dout, n)
    _check_same_device("bbit_linear_dw_sum", plan.perm, plan.scode,
                       plan.offsets, dout)
    out = _dw_sum_launch(plan, dout, vsize, dw_sum_span(n, vsize), dtype)
    _count(bbit_linear_bwd_dw, dtype)
    return out


def _dw_sum_launch(plan: DwPlan, dout: torch.Tensor, vsize: int,
                   span: int, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Launches B8's sum with ``span`` values of dW a block
    (``dw_sum_span``'s, on the main path), dW in ``dtype``."""
    k, n = plan.perm.shape
    if -(-vsize // span) > MAX_GRID_Y:
        raise ValueError(f"bbit_linear_dw_sum: V={vsize} needs more than "
                         f"{MAX_GRID_Y} blocks of {span} values")
    c = dout.shape[1]
    dev = plan.perm.device
    out = torch.empty((k, vsize, c), dtype=dtype, device=dev)
    lib = _build.load("bbit_linear")
    with torch.cuda.device(dev):
        code = lib.repro_bbit_linear_dw_sum(
            plan.scode.data_ptr(), plan.perm.data_ptr(),
            plan.offsets.data_ptr(), dout.data_ptr(), out.data_ptr(), n, k,
            vsize, c, span, 8 * (dw_plan_passes(vsize) - 1),
            int(dtype == torch.bfloat16), dev.index,
            _build.stream(plan.perm))
    _build.check("bbit_linear", code, "bbit_linear_dw_sum")
    return out


def bbit_linear_bwd_dw(codes: torch.Tensor, dout: torch.Tensor,
                       vsize: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B8: dW (k, V, C) in ``dtype`` (float32 or bfloat16) from int32
    codes (n, k) and dout f32 (n, C); codes outside [0, V) add nothing.
    On the card: the plan of ``codes`` (built once per tensor and kept,
    see the module's docstring), then the sum over it."""
    _check_dtype("bbit_linear_bwd_dw", dtype)
    if _build.on_cpu("bbit_linear_bwd_dw", codes):
        return bbit_linear_bwd_dw_plain(codes, dout, vsize, dtype=dtype)
    _check_codes("bbit_linear_bwd_dw", codes)
    _check_dout("bbit_linear_bwd_dw", dout, codes.shape[0])
    _check_same_device("bbit_linear_bwd_dw", codes, dout)
    return bbit_linear_dw_sum(_DW_PLANS.get(codes, vsize,
                                            bbit_linear_dw_plan),
                              dout, vsize, dtype)


bbit_linear_bwd_dw.launches = LaunchCount()
bbit_linear_bwd_dw.launches_bf16 = LaunchCount()
bbit_linear_bwd_dw.plan_builds = _DW_PLANS.builds
bbit_linear_bwd_dw.plan_hits = _DW_PLANS.hits
bbit_linear_bwd_dw.clear_plans = _DW_PLANS.clear


def packed_fwd_layout(n: int, sms: int) -> int:
    """B5's rows (warps) a block for n rows on a card of ``sms`` SMs: one,
    so that a few rows spread over as many SMs, doubled (up to
    ``PACKED_FWD_MAX_ROWS``) while the grid would give an SM more than
    ``PACKED_FWD_BLOCKS_PER_SM`` blocks."""
    rows = 1
    while (rows < PACKED_FWD_MAX_ROWS
           and -(-n // rows) > sms * PACKED_FWD_BLOCKS_PER_SM):
        rows *= 2
    return rows


def packed_fwd_vec(bits: int, p_w: int, ptr: int) -> bool:
    """True where every packed row starts aligned to ``bits`` bytes, so
    B5 reads a lane's 8 codes (``bits`` whole bytes) with one load."""
    return p_w % bits == 0 and ptr % bits == 0


def _packed_fwd_launch(packed: torch.Tensor, weights: torch.Tensor, k: int,
                       bits: int, empty: Optional[torch.Tensor], rows: int,
                       vec: bool) -> torch.Tensor:
    """One launch of B5 with ``rows`` rows a block and, if ``vec``, one
    load a lane's codes, on checked CUDA inputs."""
    n = packed.shape[0]
    v, c = weights.shape[1], weights.shape[2]
    out = torch.empty((n, c), dtype=torch.float32, device=packed.device)
    lib = _build.load("bbit_linear")
    with torch.cuda.device(packed.device):
        code = lib.repro_bbit_linear_packed_fwd(
            packed.data_ptr(), weights.data_ptr(),
            None if empty is None else empty.data_ptr(), out.data_ptr(),
            n, k, bits, v, c, packed.shape[1],
            0 if empty is None else empty.shape[1], rows, int(vec),
            int(weights.dtype == torch.bfloat16), packed.device.index,
            _build.stream(packed))
    _build.check("bbit_linear", code, "bbit_linear_packed_fwd")
    return out


def bbit_linear_packed_fwd(packed: torch.Tensor, weights: torch.Tensor, *,
                           k: int, bits: int,
                           empty: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """B5: logits f32 (n, C) from packed uint8 (n, ceil(k·bits/8)), table
    f32 or bf16 (k, V, C) with V ≥ 2^bits, and ``empty`` uint8 (n,
    ceil(k/8)) or None."""
    check_bits(bits)
    if _build.on_cpu("bbit_linear_packed_fwd", packed):
        return bbit_linear_packed_fwd_plain(packed, weights, k=k, bits=bits,
                                            empty=empty)
    _check_packed("bbit_linear_packed_fwd", packed, k, bits, empty)
    _check_table("bbit_linear_packed_fwd", weights, k, 1 << bits)
    _check_same_device("bbit_linear_packed_fwd", packed, weights, empty)
    out = _packed_fwd_launch(
        packed, weights, k, bits, empty,
        packed_fwd_layout(packed.shape[0],
                          _build.sm_count(packed.device.index)),
        packed_fwd_vec(bits, packed.shape[1], packed.data_ptr()))
    _count(bbit_linear_packed_fwd, weights.dtype)
    return out


bbit_linear_packed_fwd.launches = LaunchCount()
bbit_linear_packed_fwd.launches_bf16 = LaunchCount()


def packed_dw_layout(n: int) -> Tuple[int, int]:
    """B6's (warps a block, blocks a cluster along the rows) for n rows,
    from the shape alone, so that dW sums in the same order on every run
    and every card.  The cluster: as many blocks as there are 32-row
    groups, a power of two up to ``PACKED_DW_MAX_PARTS``; the warps: one a
    32-row group of a block's span, at most ``PACKED_DW_WARPS``.  The grid
    has ceil(k / 8) such clusters."""
    groups = max(-(-n // PACKED_DW_ROWS), 1)
    parts = 1
    while 2 * parts <= min(groups, PACKED_DW_MAX_PARTS):
        parts *= 2
    return min(-(-groups // parts), PACKED_DW_WARPS), parts


def _packed_dw_launch(packed: torch.Tensor, dout: torch.Tensor, vsize: int,
                      k: int, bits: int, empty: Optional[torch.Tensor],
                      warps: int, parts: int, vec: bool,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One launch of B6 on checked CUDA inputs: ``warps`` warps a block,
    ``parts`` blocks a cluster along the rows (``packed_dw_layout``'s, on
    the main path); ``vec``: one load a row's 8 codes
    (``packed_fwd_vec``); dW in ``dtype``."""
    n, c = dout.shape
    out = torch.empty((k, vsize, c), dtype=dtype, device=packed.device)
    lib = _build.load("bbit_linear")
    with torch.cuda.device(packed.device):
        code = lib.repro_bbit_linear_packed_bwd_dw(
            packed.data_ptr(), None if empty is None else empty.data_ptr(),
            dout.data_ptr(), out.data_ptr(), n, k, bits, vsize, c,
            packed.shape[1], 0 if empty is None else empty.shape[1], warps,
            parts, int(vec), int(dtype == torch.bfloat16),
            packed.device.index, _build.stream(packed))
    _build.check("bbit_linear", code, "bbit_linear_packed_bwd_dw")
    return out


def bbit_linear_packed_bwd_dw(packed: torch.Tensor, dout: torch.Tensor,
                              vsize: int, *, k: int, bits: int,
                              empty: Optional[torch.Tensor] = None,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """B6: dW (k, V, C) in ``dtype`` (float32 or bfloat16), V =
    ``vsize`` ≥ 2^bits, from packed uint8 rows, dout f32 (n, C) and
    ``empty`` uint8 (n, ceil(k/8)) or None; marked bins add nothing."""
    check_bits(bits)
    _check_dtype("bbit_linear_packed_bwd_dw", dtype)
    if _build.on_cpu("bbit_linear_packed_bwd_dw", packed):
        return bbit_linear_packed_bwd_dw_plain(
            packed, dout, vsize, k=k, bits=bits, empty=empty, dtype=dtype)
    _check_packed("bbit_linear_packed_bwd_dw", packed, k, bits, empty)
    n = packed.shape[0]
    _check_dout("bbit_linear_packed_bwd_dw", dout, n)
    if vsize < (1 << bits):
        raise ValueError(f"bbit_linear_packed_bwd_dw: vsize {vsize} < "
                         f"2^{bits}")
    _check_same_device("bbit_linear_packed_bwd_dw", packed, dout, empty)
    warps, parts = packed_dw_layout(n)
    out = _packed_dw_launch(packed, dout, vsize, k, bits, empty, warps, parts,
                            packed_fwd_vec(bits, packed.shape[1],
                                           packed.data_ptr()), dtype)
    _count(bbit_linear_packed_bwd_dw, dtype)
    return out


bbit_linear_packed_bwd_dw.launches = LaunchCount()
bbit_linear_packed_bwd_dw.launches_bf16 = LaunchCount()
