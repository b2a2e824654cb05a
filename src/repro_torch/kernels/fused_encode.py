"""Fused hash → b-bit → pack encode: kernels B1 and B2 and their plain
versions (counterpart of ``repro/kernels/fused_encode.py``).

``minhash_pack`` and ``oph_pack`` launch the CUDA kernels of
``csrc/fused_encode.cu`` on CUDA tensors and take the plain torch
version on CPU tensors; any other device raises.  Output layouts are
the reference's: codes LSB-first, ceil(k·b/8) bytes per row; the empty
mask MSB-first (``np.packbits``), ceil(k/8) bytes per row.  B1 packs at
any b from 1 to 16 (a code may straddle bytes); B2 needs b in
{1, 2, 4, 8}, so no code straddles a byte.

Hash parameters arrive as int32 tensors holding the uint32 words'
bits (``core.universal_hash.words_to_int32``).  A launch's output
allocation is the span ``kernel.alloc`` (``obs``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import obs
from repro_torch.core.bbit import (pack_codes_torch, pack_mask_torch,
                                   packed_mask_width, packed_width)
from repro_torch.core.minhash import minhash_torch
from repro_torch.core.oph import (_check_k, densify_rotation,
                                  oph_bin_minima_torch)
from repro_torch.core.universal_hash import int32_to_words
from repro_torch.kernels import _build
from repro_torch.obs import LaunchCount
# b where codes never straddle byte bounds (B2, B5, B6), and the b that
# B1 packs: their home is the cost model's eligibility
from repro_torch.perf.cost_model import MINHASH_PACK_BITS, PACK_BITS

obs.declare("kernel.alloc")

# B1 (csrc/fused_encode.cu): hash lanes a thread at most, the blocks an SM
# is given before a block takes more lanes, the warps the grid aims at, the
# id slices a block aims at, and warps a block at least and at most
# (kMinMaxWarps); scripts/sweep_serving_kernels.py times each layout at the
# engine's shapes
MINHASH_PACK_MAX_LANES_PER_THREAD = 8
MINHASH_PACK_BLOCKS_PER_SM = 8
MINHASH_PACK_WARPS_A_GRID = 2048
MINHASH_PACK_MIN_SLICES = 16
MINHASH_PACK_MIN_WARPS = 4
MINHASH_PACK_MAX_WARPS = 16
# B2 (csrc/fused_encode.cu): ids a thread loads in one pass (kPackIds),
# the passes a block's threads are sized for, and threads a block at most
# (kPackMaxThreads) and at least (one warp); scripts/sweep_serving_kernels.py
# times each threads a block at the engine's shapes
OPH_PACK_IDS_PER_THREAD = 8
OPH_PACK_PASSES = 2
OPH_PACK_MAX_THREADS = 1024
OPH_PACK_MIN_THREADS = 32


def check_bits(bits: int) -> None:
    if bits not in PACK_BITS:
        raise ValueError(f"fused packing needs b ∈ {PACK_BITS}, got {bits}")


def check_minhash_bits(bits: int) -> None:
    if bits not in MINHASH_PACK_BITS:
        raise ValueError(f"minhash_pack needs b in [1, 16], got {bits}")


def minhash_pack_min_lanes(bits: int) -> int:
    """The fewest hash lanes whose b-bit codes fill whole bytes,
    lcm(b, 8) / b = 8 / gcd(b, 8): 8 lanes (3 bytes) at b=3, 4 (3 bytes)
    at b=6, 2 (3 bytes) at b=12, 1 (2 bytes) at b=16."""
    return 8 // math.gcd(bits, 8)


def prefix_mask(indices: torch.Tensor, nnz: torch.Tensor) -> torch.Tensor:
    """bool (n, m): column < nnz of its row."""
    cols = torch.arange(indices.shape[1], device=indices.device)
    return cols[None, :] < nnz.to(torch.int64)[:, None]


def _check_cuda_args(what: str, indices, nnz, a, b) -> None:
    for name, t in (("indices", indices), ("nnz", nnz), ("a", a), ("b", b)):
        if t.device != indices.device:
            raise ValueError(f"{what}: {name} is on {t.device}, indices on "
                             f"{indices.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if indices.dim() != 2 or nnz.shape != (indices.shape[0],):
        raise ValueError(f"{what}: indices (n, m) and nnz (n,) expected, got "
                         f"{tuple(indices.shape)} and {tuple(nnz.shape)}")


# ---------------------------------------------------------------------------
# B1: minwise.
# ---------------------------------------------------------------------------
def minhash_pack_plain(indices: torch.Tensor, nnz: torch.Tensor,
                       a: torch.Tensor, b: torch.Tensor, *,
                       bits: int) -> torch.Tensor:
    """B1's plain version: min-hash → low ``bits`` bits → packed uint8
    (n, ceil(k·bits/8)) in torch ops on the inputs' device, for any b in
    [1, 16]; also the computation the reference runs through XLA where
    the fused kernel does not apply."""
    mask = prefix_mask(indices, nnz)
    z = minhash_torch(indices, mask, int32_to_words(a), int32_to_words(b))
    return pack_codes_torch(z & ((1 << bits) - 1), bits)


def minhash_pack_layout(n: int, k: int, bits: int,
                        sms: int) -> Tuple[int, int, int]:
    """B1's (hash lanes a thread, threads of them a block, warps a block)
    for n rows, k lanes and b bits on a card of ``sms`` SMs.  The lanes a
    block: the fewest (a power of two, a multiple of
    ``minhash_pack_min_lanes(bits)`` so they are whole bytes of codes, at
    most 256) that keep the grid of n · ceil(k / lanes) blocks
    within ``MINHASH_PACK_BLOCKS_PER_SM`` an SM, so that a few rows spread
    over the card; a thread takes up to 8 of them.  The warps: enough that
    the grid holds ``MINHASH_PACK_WARPS_A_GRID`` warps and a block
    ``MINHASH_PACK_MIN_SLICES`` id slices (32 / threads a warp), a power of
    two in [``MINHASH_PACK_MIN_WARPS``, ``MINHASH_PACK_MAX_WARPS``].  The
    row length does not enter: the engine's lanes of 2,048 and 8,192 ids
    share the layout of their row bucket."""
    lanes = minhash_pack_min_lanes(bits)
    while lanes < 256 and n * -(-k // lanes) > sms * MINHASH_PACK_BLOCKS_PER_SM:
        lanes *= 2
    lpt = min(lanes, MINHASH_PACK_MAX_LANES_PER_THREAD)
    lt = lanes // lpt
    blocks = max(n * -(-k // lanes), 1)
    want = max(-(-MINHASH_PACK_WARPS_A_GRID // blocks),
               -(-MINHASH_PACK_MIN_SLICES * lt // 32), 1)
    warps = 1 << (want - 1).bit_length()
    return lpt, lt, max(MINHASH_PACK_MIN_WARPS,
                        min(warps, MINHASH_PACK_MAX_WARPS))


def _minhash_pack_launch(indices: torch.Tensor, nnz: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor, bits: int,
                         lpt: int, lt: int, warps: int,
                         vec: bool) -> torch.Tensor:
    """One launch of B1 on checked CUDA inputs: ``lpt`` hash lanes a
    thread, ``lt`` such threads and ``warps`` warps a block
    (``minhash_pack_layout``'s, on the main path), ``vec`` int4 id loads
    (``oph_pack_vec``)."""
    n, m = indices.shape
    k = a.shape[0]
    with obs.span("kernel.alloc"):
        out = torch.empty((n, packed_width(k, bits)), dtype=torch.uint8,
                          device=indices.device)
    lib = _build.load("fused_encode")
    with torch.cuda.device(indices.device):
        code = lib.repro_minhash_pack(
            indices.data_ptr(), nnz.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, m, k, bits, out.shape[1], lpt, lt, warps,
            int(vec), indices.device.index, _build.stream(indices))
    _build.check("fused_encode", code, "minhash_pack")
    return out


def minhash_pack(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, *, bits: int) -> torch.Tensor:
    """uint8 (n, ceil(k·bits/8)) packed b-bit min-hash codes, 1 ≤ bits ≤ 16.

    indices int32 (n, m) contiguously padded rows; nnz int32 (n,) valid
    prefix lengths; a, b int32 (k,) multiply-shift words (a odd).
    """
    check_minhash_bits(bits)
    if _build.on_cpu("minhash_pack", indices):
        return minhash_pack_plain(indices, nnz, a, b, bits=bits)
    _check_cuda_args("minhash_pack", indices, nnz, a, b)
    n, m = indices.shape
    lpt, lt, warps = minhash_pack_layout(
        n, a.shape[0], bits, _build.sm_count(indices.device.index))
    out = _minhash_pack_launch(indices, nnz, a, b, bits, lpt, lt, warps,
                               oph_pack_vec(m, indices.data_ptr()))
    minhash_pack.launches.add()
    return out


minhash_pack.launches = LaunchCount()


# ---------------------------------------------------------------------------
# B2: one permutation hashing.
# ---------------------------------------------------------------------------
def oph_pack_plain(indices: torch.Tensor, nnz: torch.Tensor,
                   a: torch.Tensor, b: torch.Tensor, *, k: int, bits: int,
                   densify: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2's plain version: OPH bin minima → densify or zero-code → b bits
    → pack, in torch ops on the inputs' device, for any b in [1, 16]
    → (packed, packbits empty mask)."""
    vals, empty = oph_bin_minima_torch(indices, prefix_mask(indices, nnz),
                                       int32_to_words(a), int32_to_words(b),
                                       k)
    mask_b = (1 << bits) - 1
    if densify:
        # all-empty rows keep the sentinel → all-ones low bits
        codes = densify_rotation(vals, empty)[0] & mask_b
    else:
        codes = torch.where(empty, 0, vals & mask_b)
    return pack_codes_torch(codes, bits), pack_mask_torch(empty)


def oph_pack_layout(m: int, k: int) -> int:
    """B2's threads a block (a block a row) for rows padded to m ids and k
    bins: enough that ``OPH_PACK_PASSES`` passes of
    ``OPH_PACK_IDS_PER_THREAD`` ids each cover the padded row, and one a
    bin for the finish, as a power of two in [``OPH_PACK_MIN_THREADS``,
    ``OPH_PACK_MAX_THREADS``]."""
    want = max(-(-m // (OPH_PACK_IDS_PER_THREAD * OPH_PACK_PASSES)), k, 1)
    threads = 1 << (want - 1).bit_length()
    return max(OPH_PACK_MIN_THREADS, min(OPH_PACK_MAX_THREADS, threads))


def oph_pack_vec(m: int, ptr: int) -> bool:
    """True where every row of int32 ids starts 16-byte aligned, so B2 (and
    B1) read them 4 at a time (int4)."""
    return m % 4 == 0 and ptr % 16 == 0


def _oph_pack_launch(indices: torch.Tensor, nnz: torch.Tensor,
                     a: torch.Tensor, b: torch.Tensor, k: int, bits: int,
                     densify: bool, threads: int, vec: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of B2 with ``threads`` a block on checked CUDA inputs;
    ``vec``: int4 loads (``oph_pack_vec``)."""
    n, m = indices.shape
    with obs.span("kernel.alloc"):
        out = torch.empty((n, packed_width(k, bits)), dtype=torch.uint8,
                          device=indices.device)
        eout = torch.empty((n, packed_mask_width(k)), dtype=torch.uint8,
                           device=indices.device)
    lib = _build.load("fused_encode")
    with torch.cuda.device(indices.device):
        code = lib.repro_oph_pack(
            indices.data_ptr(), nnz.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), eout.data_ptr(), n, m, k, _check_k(k), bits,
            int(densify), out.shape[1], eout.shape[1], threads, int(vec),
            indices.device.index, _build.stream(indices))
    _build.check("fused_encode", code, "oph_pack")
    return out, eout


def oph_pack(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, *, k: int, bits: int, densify: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed uint8 (n, ceil(k·bits/8)), empty uint8 (n, ceil(k/8))).

    One hash per nonzero, per-bin minima, then rotation densification
    (``densify=True``) or zero-coding (empty bins → code 0); ``empty``
    marks the raw empty bins in both modes.  a, b are int32 (1,) words.
    """
    check_bits(bits)
    _check_k(k)
    if _build.on_cpu("oph_pack", indices):
        return oph_pack_plain(indices, nnz, a, b, k=k, bits=bits,
                              densify=densify)
    _check_cuda_args("oph_pack", indices, nnz, a, b)
    m = indices.shape[1]
    out = _oph_pack_launch(indices, nnz, a, b, k, bits, densify,
                           oph_pack_layout(m, k),
                           oph_pack_vec(m, indices.data_ptr()))
    oph_pack.launches.add()
    return out


oph_pack.launches = LaunchCount()
