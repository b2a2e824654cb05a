"""b-bit linear layer kernels and their plain versions (counterpart of
``repro/kernels/bbit_linear.py``).

    forward:  logits[n, c] = Σ_j W[j, code(n, j), c]
    backward: dW[j, v, c]  = Σ_n 1{code(n, j) = v} · dout[n, c]

from widened int32 (n, k) codes (B7 ``bbit_linear_fwd``, B8
``bbit_linear_bwd_dw``) or straight from packed uint8 rows in the
``core.bbit`` layout (B5 ``bbit_linear_packed_fwd``, B6
``bbit_linear_packed_bwd_dw``), where an optional packbits empty mask
(``oph_zero``) drops the marked bins.  Each wrapper launches its CUDA
kernel of ``csrc/bbit_linear.cu`` on CUDA tensors and takes the plain
version on CPU tensors.  The kernels sum in another order than torch,
so the two agree to float32 rounding (allclose), not bit for bit; the
kernels themselves sum in a fixed order, with no float atomics, and
give the same bits on every run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.bbit import (packed_mask_width, packed_width,
                                   unpack_codes_torch, unpack_mask_torch)
from repro_torch.kernels import _build
from repro_torch.kernels.counters import LaunchCount
from repro_torch.kernels.fused_encode import check_bits

# dW: bins per block (csrc kDwWarps), values per V tile (csrc kDwVTile),
# and the grid the row splits aim at
DW_BINS_PER_BLOCK = 8
DW_V_TILE = 4096
DW_TARGET_BLOCKS = 512
DW_MIN_ROWS_PER_SPLIT = 256
DW_MAX_SCRATCH_FLOATS = 1 << 26     # 256 MiB of partial tables


def gather_sum(codes: torch.Tensor, weights: torch.Tensor,
                empty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_j W[j, codes[:, j], :] over the bins not marked in bool
    ``empty`` (n, k), in torch ops (differentiable in W)."""
    j = torch.arange(codes.shape[1], device=codes.device)
    gathered = weights[j[None, :], codes.to(torch.int64)].to(torch.float32)
    if empty is not None:
        gathered = gathered.masked_fill(empty[:, :, None], 0.0)
    return gathered.sum(dim=1)


def _histogram(codes: torch.Tensor, dout: torch.Tensor, vsize: int,
               empty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW (k, V, C): ``dout`` rows added into the bins their codes pick,
    skipping the bins marked in bool ``empty`` (n, k), in torch ops."""
    n, k = codes.shape
    c = dout.shape[1]
    flat = (torch.arange(k, device=codes.device) * vsize)[None, :] \
        + codes.to(torch.int64)
    rows = dout.to(torch.float32)[:, None, :].expand(n, k, c)
    if empty is not None:
        rows = rows.masked_fill(empty[:, :, None], 0.0)
    dw = torch.zeros((k * vsize, c), dtype=torch.float32, device=codes.device)
    dw.index_add_(0, flat.reshape(-1), rows.reshape(n * k, c))
    return dw.view(k, vsize, c)


def bbit_linear_fwd_plain(codes: torch.Tensor, weights: torch.Tensor,
                          empty: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """B7's plain version (``ref.bbit_linear_fwd``): gather → sum; bool
    ``empty`` (n, k) drops the marked bins, as the reference's masked
    gather in ``bbit_logits`` does."""
    return gather_sum(codes, weights, empty)


def bbit_linear_bwd_dw_plain(codes: torch.Tensor, dout: torch.Tensor,
                             vsize: int,
                             empty: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """B8's plain version (``ref.bbit_linear_bwd_dw``); bool ``empty``
    (n, k) drops the marked bins."""
    return _histogram(codes, dout, vsize, empty)


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
                                    empty: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """B6's plain version (``ref.bbit_linear_packed_bwd_dw``)."""
    return _histogram(unpack_codes_torch(packed, k, bits), dout, vsize,
                      None if empty is None else unpack_mask_torch(empty, k))


def _check_same_device(what: str, first: torch.Tensor, *rest) -> None:
    for t in (first, *rest):
        if t is not None and (t.device != first.device
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: inputs must be contiguous and on "
                             f"{first.device}")


def _check_table(what: str, weights: torch.Tensor, k: int, min_v: int):
    if (weights.dtype != torch.float32 or weights.dim() != 3
            or weights.shape[0] != k or weights.shape[1] < min_v):
        raise ValueError(f"{what}: weights must be float32 (k={k}, "
                         f"V>={min_v}, C), got {weights.dtype} "
                         f"{tuple(weights.shape)}")


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


def dw_row_splits(n: int, k: int, v: int, c: int) -> Tuple[int, int]:
    """(splits, rows per split) of the dW kernels' rows: enough blocks
    (bin groups x V tiles x splits) to fill the card, at least 256 rows
    each, a bounded scratch.  A
    function of the shapes only, so dW sums in the same order on every
    run."""
    n = max(n, 1)
    blocks = -(-k // DW_BINS_PER_BLOCK) * -(-v // DW_V_TILE)
    splits = min(-(-DW_TARGET_BLOCKS // blocks),
                 -(-n // DW_MIN_ROWS_PER_SPLIT),
                 max(1, DW_MAX_SCRATCH_FLOATS // max(k * v * c, 1)))
    rows = -(-n // splits)
    rows = -(-rows // 32) * 32          # a whole number of 32-row tiles
    return -(-n // rows), rows


def _dw_buffers(n: int, k: int, v: int, c: int, device: torch.device):
    """→ (out (k, V, C), scratch of the row splits' partial tables or
    ``out`` itself when there is one split, splits, rows per split)."""
    splits, rows = dw_row_splits(n, k, v, c)
    out = torch.empty((k, v, c), dtype=torch.float32, device=device)
    part = (out if splits == 1 else
            torch.empty((splits, k, v, c), dtype=torch.float32,
                        device=device))
    return out, part, splits, rows


def bbit_linear_fwd(codes: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """B7: logits f32 (n, C) from int32 codes (n, k) in [0, V) and a
    table f32 (k, V, C)."""
    if _build.on_cpu("bbit_linear_fwd", codes):
        return bbit_linear_fwd_plain(codes, weights)
    n, k = codes.shape
    if codes.dtype != torch.int32:
        raise ValueError(f"bbit_linear_fwd: codes must be int32, got "
                         f"{codes.dtype}")
    _check_table("bbit_linear_fwd", weights, k, 1)
    _check_same_device("bbit_linear_fwd", codes, weights)
    v, c = weights.shape[1], weights.shape[2]
    out = torch.empty((n, c), dtype=torch.float32, device=codes.device)
    lib = _build.load("bbit_linear")
    with torch.cuda.device(codes.device):
        code = lib.repro_bbit_linear_fwd(
            codes.data_ptr(), weights.data_ptr(), out.data_ptr(), n, k, v, c,
            codes.device.index, _build.stream(codes))
    _build.check("bbit_linear", code, "bbit_linear_fwd")
    bbit_linear_fwd.launches.add()
    return out


bbit_linear_fwd.launches = LaunchCount()


def bbit_linear_bwd_dw(codes: torch.Tensor, dout: torch.Tensor,
                       vsize: int) -> torch.Tensor:
    """B8: dW f32 (k, V, C) from int32 codes (n, k) and dout f32 (n, C);
    codes outside [0, V) add nothing."""
    if _build.on_cpu("bbit_linear_bwd_dw", codes):
        return bbit_linear_bwd_dw_plain(codes, dout, vsize)
    n, k = codes.shape
    if codes.dtype != torch.int32:
        raise ValueError(f"bbit_linear_bwd_dw: codes must be int32, got "
                         f"{codes.dtype}")
    _check_dout("bbit_linear_bwd_dw", dout, n)
    _check_same_device("bbit_linear_bwd_dw", codes, dout)
    c = dout.shape[1]
    out, part, splits, rows = _dw_buffers(n, k, vsize, c, codes.device)
    lib = _build.load("bbit_linear")
    with torch.cuda.device(codes.device):
        code = lib.repro_bbit_linear_bwd_dw(
            codes.data_ptr(), dout.data_ptr(), part.data_ptr(),
            out.data_ptr(), n, k, vsize, c, splits, rows,
            codes.device.index, _build.stream(codes))
    _build.check("bbit_linear", code, "bbit_linear_bwd_dw")
    bbit_linear_bwd_dw.launches.add()
    return out


bbit_linear_bwd_dw.launches = LaunchCount()


def bbit_linear_packed_fwd(packed: torch.Tensor, weights: torch.Tensor, *,
                           k: int, bits: int,
                           empty: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """B5: logits f32 (n, C) from packed uint8 (n, ceil(k·bits/8)), table
    f32 (k, V, C) with V ≥ 2^bits, and ``empty`` uint8 (n, ceil(k/8))
    or None."""
    check_bits(bits)
    if _build.on_cpu("bbit_linear_packed_fwd", packed):
        return bbit_linear_packed_fwd_plain(packed, weights, k=k, bits=bits,
                                            empty=empty)
    _check_packed("bbit_linear_packed_fwd", packed, k, bits, empty)
    _check_table("bbit_linear_packed_fwd", weights, k, 1 << bits)
    _check_same_device("bbit_linear_packed_fwd", packed, weights, empty)
    n = packed.shape[0]
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


def bbit_linear_packed_bwd_dw(packed: torch.Tensor, dout: torch.Tensor,
                              vsize: int, *, k: int, bits: int,
                              empty: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """B6: dW f32 (k, V, C), V = ``vsize`` ≥ 2^bits, from packed uint8
    rows, dout f32 (n, C) and ``empty`` uint8 (n, ceil(k/8)) or None;
    marked bins add nothing."""
    check_bits(bits)
    if _build.on_cpu("bbit_linear_packed_bwd_dw", packed):
        return bbit_linear_packed_bwd_dw_plain(packed, dout, vsize, k=k,
                                               bits=bits, empty=empty)
    _check_packed("bbit_linear_packed_bwd_dw", packed, k, bits, empty)
    n = packed.shape[0]
    _check_dout("bbit_linear_packed_bwd_dw", dout, n)
    if vsize < (1 << bits):
        raise ValueError(f"bbit_linear_packed_bwd_dw: vsize {vsize} < "
                         f"2^{bits}")
    _check_same_device("bbit_linear_packed_bwd_dw", packed, dout, empty)
    c = dout.shape[1]
    out, part, splits, rows = _dw_buffers(n, k, vsize, c, packed.device)
    lib = _build.load("bbit_linear")
    with torch.cuda.device(packed.device):
        code = lib.repro_bbit_linear_packed_bwd_dw(
            packed.data_ptr(), None if empty is None else empty.data_ptr(),
            dout.data_ptr(), part.data_ptr(), out.data_ptr(), n, k, bits,
            vsize, c, packed.shape[1],
            0 if empty is None else empty.shape[1], splits, rows,
            packed.device.index, _build.stream(packed))
    _build.check("bbit_linear", code, "bbit_linear_packed_bwd_dw")
    bbit_linear_packed_bwd_dw.launches.add()
    return out


bbit_linear_packed_bwd_dw.launches = LaunchCount()
