"""Raw one-permutation-hashing bin minima: kernel B4 and its plain
version (counterpart of ``repro/kernels/oph.py``).

    h = fmix32(a·t + b) once per nonzero, bin = h >> (32 − log2 k),
    out[i, j] = min of h over row i's ids in bin j

as uint32 words, 0xFFFFFFFF for an empty bin, no densify (the caller
densifies or zero-codes, ``core.schemes``).  k must be a power of two.
``oph`` launches the CUDA kernel of ``csrc/oph.cu`` on CUDA tensors and
takes the plain version on CPU tensors; any other device raises.  Words
travel as int32 tensors holding their bits: widen them with
``int32_to_words`` before the sentinel test.
"""
from __future__ import annotations

import torch

from repro_torch.core.oph import _check_k, oph_bin_minima_torch
from repro_torch.core.universal_hash import int32_to_words, words_as_int32
from repro_torch.kernels import _build
from repro_torch.obs import LaunchCount
from repro_torch.kernels.fused_encode import _check_cuda_args, prefix_mask


def oph_plain(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, *, k: int) -> torch.Tensor:
    """B4's plain version: ``core.oph.oph_bin_minima_torch`` over each
    row's first nnz ids → int32 (n, k) word bits."""
    vals, _ = oph_bin_minima_torch(indices, prefix_mask(indices, nnz),
                                   int32_to_words(a), int32_to_words(b), k)
    return words_as_int32(vals)


def oph(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, *, k: int) -> torch.Tensor:
    """int32 (n, k) bits of the uint32 bin minima.

    indices int32 (n, m) contiguously padded rows; nnz int32 (n,);
    a, b int32 (1,) words of the single hash; k a power of two ≥ 2.
    """
    shift = _check_k(k)
    if _build.on_cpu("oph", indices):
        return oph_plain(indices, nnz, a, b, k=k)
    _check_cuda_args("oph", indices, nnz, a, b)
    n, m = indices.shape
    out = torch.empty((n, k), dtype=torch.int32, device=indices.device)
    lib = _build.load("oph")
    with torch.cuda.device(indices.device):
        code = lib.repro_oph(
            indices.data_ptr(), nnz.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, m, k, shift, indices.device.index,
            _build.stream(indices))
    _build.check("oph", code, "oph")
    oph.launches.add()
    return out


oph.launches = LaunchCount()
