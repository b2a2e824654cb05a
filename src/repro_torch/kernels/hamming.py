"""Packed-code Hamming distances: kernel B10 and its plain version
(counterpart of ``repro/kernels/hamming.py``).

    dist[i] = Σ_c popcount(cands[i, c] XOR query[c])

over uint8 packed code rows (``core.bbit`` layout; both pad their last
byte with zeros).  ``hamming_distance`` launches the CUDA kernel of
``csrc/hamming.cu`` on CUDA tensors and takes the plain version on CPU
tensors; any other device raises.  Integer sums, so the kernel and the
plain version give the same int32 in any order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.counters import LaunchCount


def _popcount_table(device) -> torch.Tensor:
    """int32 (256,): the number of set bits of each byte value."""
    v = torch.arange(256, dtype=torch.int32, device=device)
    return sum((v >> s) & 1 for s in range(8))


def hamming_distance_plain(query: torch.Tensor,
                           cands: torch.Tensor) -> torch.Tensor:
    """B10's plain version: XOR, a 256-entry popcount table gathered,
    a sum per row → int32 (n,)."""
    x = torch.bitwise_xor(cands, query[None, :]).to(torch.int64)
    return _popcount_table(cands.device)[x].sum(dim=1, dtype=torch.int32)


def hamming_distance(query: torch.Tensor,
                     cands: torch.Tensor) -> torch.Tensor:
    """int32 (n,) distances between a uint8 query (w,) and uint8
    candidate rows (n, w)."""
    if (query.dtype != torch.uint8 or cands.dtype != torch.uint8
            or cands.dim() != 2 or query.shape != (cands.shape[1],)):
        raise ValueError(
            "hamming_distance: uint8 query (w,) and cands (n, w) expected, "
            f"got {query.dtype} {tuple(query.shape)} and {cands.dtype} "
            f"{tuple(cands.shape)}")
    if _build.on_cpu("hamming_distance", cands):
        return hamming_distance_plain(query, cands)
    if query.device != cands.device:
        raise ValueError(f"hamming_distance: query is on {query.device}, "
                         f"cands on {cands.device}")
    query, cands = query.contiguous(), cands.contiguous()
    n, w = cands.shape
    aligned = int(w % 4 == 0 and cands.data_ptr() % 4 == 0)
    out = torch.empty((n,), dtype=torch.int32, device=cands.device)
    lib = _build.load("hamming")
    with torch.cuda.device(cands.device):
        code = lib.repro_hamming_distance(
            query.data_ptr(), cands.data_ptr(), out.data_ptr(), n, w,
            aligned, cands.device.index, _build.stream(cands))
    _build.check("hamming", code, "hamming_distance")
    hamming_distance.launches.add()
    return out


hamming_distance.launches = LaunchCount()
