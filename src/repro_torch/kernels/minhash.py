"""Raw minwise minima: kernel B3 and its plain version (counterpart of
``repro/kernels/minhash.py``).

    out[i, j] = min over row i's first nnz ids t of fmix32(a_j·t + b_j)

as uint32 words; 0xFFFFFFFF for a row with no id.  ``minhash`` launches
the CUDA kernel of ``csrc/minhash.cu`` on CUDA tensors and takes the
plain version on CPU tensors; any other device raises.  Words travel as
int32 tensors holding their bits (``core.universal_hash``): widen them
with ``int32_to_words`` before any comparison or mask, since int32
compares signed.
"""
from __future__ import annotations

import torch

from repro_torch.core.minhash import minhash_torch
from repro_torch.core.universal_hash import int32_to_words, words_as_int32
from repro_torch.kernels import _build
from repro_torch.obs import LaunchCount
from repro_torch.kernels.fused_encode import _check_cuda_args, prefix_mask


def minhash_plain(indices: torch.Tensor, nnz: torch.Tensor,
                  a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B3's plain version: ``core.minhash.minhash_torch`` over each row's
    first nnz ids → int32 (n, k) word bits, on the inputs' device."""
    z = minhash_torch(indices, prefix_mask(indices, nnz),
                      int32_to_words(a), int32_to_words(b))
    return words_as_int32(z)


def minhash(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """int32 (n, k) bits of the uint32 minima.

    indices int32 (n, m) contiguously padded rows; nnz int32 (n,) valid
    prefix lengths; a, b int32 (k,) multiply-shift words (a odd).
    """
    if _build.on_cpu("minhash", indices):
        return minhash_plain(indices, nnz, a, b)
    _check_cuda_args("minhash", indices, nnz, a, b)
    n, m = indices.shape
    k = a.shape[0]
    out = torch.empty((n, k), dtype=torch.int32, device=indices.device)
    lib = _build.load("minhash")
    with torch.cuda.device(indices.device):
        code = lib.repro_minhash(
            indices.data_ptr(), nnz.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, m, k, indices.device.index,
            _build.stream(indices))
    _build.check("minhash", code, "minhash")
    minhash.launches.add()
    return out


minhash.launches = LaunchCount()
