"""VW signed feature hashing: kernel B9 and its plain version
(counterpart of ``repro/kernels/vw_sketch.py``).

    out[n, hb(t) & (m − 1)] += sign(t) · value   over each row's first nnz
    hb(t) = fmix32(t·0x9E3779B1 + 2·seed + 1)
    sign(t) = +1 if bit 31 of fmix32(t ^ (0x7FEB352D + seed)) is set, else −1

with m a power of two (paper Eq. 14; ``ref.vw_sketch``).
``vw_sketch`` launches a CUDA kernel of ``csrc/vw_sketch.cu`` on CUDA
tensors and takes the plain version on CPU tensors; ``vw_layout`` picks
the kernel's design from the shapes.  The kernels sum each bucket in an
order fixed by the row, so they give the same bits on every run.
With values of ones every bucket is a small integer and the kernel
equals the plain version byte for byte; with general values the two sum
in other orders and agree to float32 rounding.
"""
from __future__ import annotations

import torch

from repro_torch.core.universal_hash import MASK32, fmix32, mul32
from repro_torch.kernels import _build
from repro_torch.obs import LaunchCount

BUCKET_MUL = 0x9E3779B1
SIGN_XOR = 0x7FEB352D
# The kernel's two designs (csrc/vw_sketch.cu).  "lanes": a block of G
# threads a row, each thread with a private column of the row's m-float
# sketch in shared memory (4·m·G bytes, at most LANES_SMEM_BYTES so that
# three blocks fit an SM), about LANES_IDS_PER_THREAD ids a thread, at
# most LANES_MAX_THREADS.  "slice": a block of 256 threads a slice of at
# most SLICE_BUCKETS buckets of one row in shared memory, halved down to
# SLICE_MIN_BUCKETS while the grid has fewer than SLICE_MIN_BLOCKS blocks.
# Lanes up to LANES_MAX_M buckets, slices above (scripts/sweep_vw_sketch.py
# times both, on the corpus's chunks).
LANES, SLICE = 0, 1
LANES_MAX_M = 256
LANES_SMEM_BYTES = 64 << 10
LANES_IDS_PER_THREAD = 8
LANES_MAX_THREADS = 256
SLICE_BUCKETS = 1 << 14
SLICE_MIN_BUCKETS = 1 << 10
SLICE_MIN_BLOCKS = 256


def vw_layout(n: int, mx: int, m_buckets: int) -> tuple:
    """(design, param) of the kernel for n rows padded to ``mx`` ids and
    ``m_buckets`` buckets, from the shapes alone: (LANES, G threads a
    row) for m ≤ LANES_MAX_M, G the power of two near mx /
    LANES_IDS_PER_THREAD within [32, LANES_MAX_THREADS] and the
    shared-memory budget; else (SLICE, buckets a block)."""
    if m_buckets <= LANES_MAX_M:
        most = max(32, min(LANES_MAX_THREADS,
                           LANES_SMEM_BYTES // (4 * m_buckets)))
        want = max(1, -(-mx // LANES_IDS_PER_THREAD))
        g = 1 << (want - 1).bit_length()
        return LANES, max(32, min(most, g))
    mb = min(m_buckets, SLICE_BUCKETS)
    while mb > SLICE_MIN_BUCKETS and n * (m_buckets // mb) < SLICE_MIN_BLOCKS:
        mb //= 2
    return SLICE, mb


def bucket_words(indices: torch.Tensor, seed: int) -> torch.Tensor:
    """fmix32(t·0x9E3779B1 + 2·seed + 1) as int64 words in [0, 2^32)."""
    t = indices.to(torch.int64) & MASK32
    return fmix32((mul32(t, BUCKET_MUL) + ((2 * seed + 1) & MASK32))
                  & MASK32)


def signs(indices: torch.Tensor, seed: int) -> torch.Tensor:
    """±1.0 float32 from bit 31 of fmix32(t ^ (0x7FEB352D + seed))."""
    t = indices.to(torch.int64) & MASK32
    hs = fmix32(t ^ ((SIGN_XOR + seed) & MASK32))
    return torch.where((hs >> 31) & 1 == 1, 1.0, -1.0).to(torch.float32)


def scatter_rows(bucket: torch.Tensor, contrib: torch.Tensor,
                 m: int) -> torch.Tensor:
    """(n, m) float32 sketch: ``contrib[i, t]`` added into bucket
    ``bucket[i, t]`` of row i."""
    n = bucket.shape[0]
    rows = torch.arange(n, device=bucket.device)[:, None] * m
    out = torch.zeros(n * m, dtype=torch.float32, device=bucket.device)
    out.index_add_(0, (rows + bucket).reshape(-1), contrib.reshape(-1))
    return out.view(n, m)


def vw_sketch_plain(indices: torch.Tensor, values: torch.Tensor,
                    nnz: torch.Tensor, m_buckets: int,
                    seed: int = 0) -> torch.Tensor:
    """B9's plain version (``ref.vw_sketch``), in torch ops."""
    mask = (torch.arange(indices.shape[1], device=indices.device)[None, :]
            < nnz.to(torch.int64)[:, None])
    bucket = bucket_words(indices, seed) & (m_buckets - 1)
    contrib = torch.where(mask, values.to(torch.float32)
                          * signs(indices, seed), 0.0)
    return scatter_rows(bucket, contrib, m_buckets)


def vw_sketch(indices: torch.Tensor, values: torch.Tensor,
              nnz: torch.Tensor, m_buckets: int,
              seed: int = 0) -> torch.Tensor:
    """f32 (n, m_buckets) sketches of int32 ids (n, M), f32 values (n, M)
    and int32 nnz (n,); ``m_buckets`` a power of two."""
    if m_buckets < 1 or m_buckets & (m_buckets - 1):
        raise ValueError(f"vw_sketch needs a power-of-two m_buckets, got "
                         f"{m_buckets}")
    if _build.on_cpu("vw_sketch", indices):
        return vw_sketch_plain(indices, values, nnz, m_buckets, seed)
    n, mx = indices.shape
    if (indices.dtype != torch.int32 or values.dtype != torch.float32
            or values.shape != indices.shape or nnz.dtype != torch.int32
            or nnz.shape != (n,)):
        raise ValueError(
            "vw_sketch: indices int32 (n, M), values float32 (n, M) and "
            f"nnz int32 (n,), got {indices.dtype} {tuple(indices.shape)}, "
            f"{values.dtype} {tuple(values.shape)}, {nnz.dtype} "
            f"{tuple(nnz.shape)}")
    for t in (indices, values, nnz):
        if t.device != indices.device or not t.is_contiguous():
            raise ValueError("vw_sketch: inputs must be contiguous and on "
                             f"{indices.device}")
    out = _launch(indices, values, nnz, m_buckets, seed,
                  *vw_layout(n, mx, m_buckets))
    vw_sketch.launches.add()
    return out


def _launch(indices, values, nnz, m_buckets: int, seed: int, design: int,
            param: int) -> torch.Tensor:
    """One launch of the kernel's ``design`` (LANES: ``param`` threads a
    row; SLICE: ``param`` buckets a block) on checked CUDA inputs."""
    n, mx = indices.shape
    out = torch.empty((n, m_buckets), dtype=torch.float32,
                      device=indices.device)
    lib = _build.load("vw_sketch")
    with torch.cuda.device(indices.device):
        code = lib.repro_vw_sketch(
            indices.data_ptr(), values.data_ptr(), nnz.data_ptr(),
            out.data_ptr(), n, mx, m_buckets, design, param, seed & MASK32,
            indices.device.index, _build.stream(indices))
    _build.check("vw_sketch", code, "vw_sketch")
    return out


vw_sketch.launches = LaunchCount()
