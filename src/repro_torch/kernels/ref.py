"""The kernels' plain torch versions under the names and signatures of the
reference's oracles (``repro/kernels/ref.py``).  Each is the function its
kernel is held to; ``minhash`` gives the int32 bits of the uint32 words,
as the port's encode does throughout (``core.universal_hash.int32_to_words``
widens them)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bbit_linear as _bl
from repro_torch.kernels.minhash import minhash_plain
from repro_torch.kernels.vw_sketch import vw_sketch_plain


def minhash(indices: torch.Tensor, nnz: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """Min of fmix32(a_j·t + b_j) over each row's first nnz indices."""
    return minhash_plain(indices, nnz, a, b)


def bbit_linear_fwd(codes: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """logits[n, c] = Σ_j W[j, codes[n, j], c], float32."""
    return _bl.bbit_linear_fwd_plain(codes, weights)


def bbit_linear_bwd_dw(codes: torch.Tensor, dout: torch.Tensor,
                       vsize: int) -> torch.Tensor:
    """dW[j, v, c] = Σ_n 1{codes[n, j] = v}·dout[n, c], float32."""
    return _bl.bbit_linear_bwd_dw_plain(codes, dout, vsize)


def bbit_linear_packed_fwd(packed: torch.Tensor, weights: torch.Tensor,
                           k: int, bits: int,
                           empty: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The forward from packed rows, bins marked in ``empty`` dropped."""
    return _bl.bbit_linear_packed_fwd_plain(packed, weights, k=k, bits=bits,
                                            empty=empty)


def bbit_linear_packed_bwd_dw(packed: torch.Tensor, dout: torch.Tensor,
                              vsize: int, k: int, bits: int,
                              empty: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """dW from packed rows, bins marked in ``empty`` adding nothing."""
    return _bl.bbit_linear_packed_bwd_dw_plain(packed, dout, vsize, k=k,
                                               bits=bits, empty=empty)


def vw_sketch(indices: torch.Tensor, values: torch.Tensor,
              nnz: torch.Tensor, m_buckets: int, seed: int) -> torch.Tensor:
    """Signed feature hashing into m buckets, float32 (n, m)."""
    return vw_sketch_plain(indices, values, nnz, m_buckets, seed)
