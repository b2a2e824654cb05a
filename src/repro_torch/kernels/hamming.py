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
from repro_torch.obs import LaunchCount

WARPS_PER_BLOCK = 8
# warps an SM keeps resident (2,048 threads); a scan larger than one wave
# of them gives each warp 2 or 4 row groups
WARPS_PER_SM = 64
MAX_REPS = 4


def load_word(w: int, *ptrs: int) -> int:
    """Bytes a load of the kernel: 16 where w % 16 == 0 and every base
    address is 16-byte aligned, else 4 where the same holds for 4, else
    1."""
    for word in (16, 4):
        if w % word == 0 and all(p % word == 0 for p in ptrs):
            return word
    return 1


def hamming_layout(n: int, w: int, word: int, sms: int) -> tuple:
    """(lanes a row, row groups a warp, threads a block, blocks) for n
    rows of w bytes read ``word`` bytes a load on a card of ``sms`` SMs:
    the power of two of lanes that covers a row's words once, at most
    32, so a group is 32 / lanes rows; 1, 2 or 4 groups a warp, the
    fewest that fit one wave of resident warps; blocks of up to
    ``WARPS_PER_BLOCK`` warps, enough of them to cover the rows."""
    words = max(1, w // word)
    lanes = min(32, 1 << (words - 1).bit_length())
    groups = max(1, -(-n // (32 // lanes)))
    reps = 1
    while reps < MAX_REPS and -(-groups // reps) > sms * WARPS_PER_SM:
        reps *= 2
    warps = -(-groups // reps)
    per_block = min(WARPS_PER_BLOCK, warps)
    return lanes, reps, 32 * per_block, -(-warps // per_block)


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
    word = load_word(w, query.data_ptr(), cands.data_ptr())
    out = _launch(query, cands, word, hamming_layout(
        n, w, word, _build.sm_count(cands.device.index)))
    hamming_distance.launches.add()
    return out


def _launch(query: torch.Tensor, cands: torch.Tensor, word: int,
            layout: tuple) -> torch.Tensor:
    """One launch at ``word`` bytes a load and ``layout`` (lanes, row
    groups a warp, threads, blocks) on checked, contiguous CUDA
    inputs."""
    n, w = cands.shape
    out = torch.empty((n,), dtype=torch.int32, device=cands.device)
    lib = _build.load("hamming")
    with torch.cuda.device(cands.device):
        code = lib.repro_hamming_distance(
            query.data_ptr(), cands.data_ptr(), out.data_ptr(), n, w, word,
            *layout, cands.device.index, _build.stream(cands))
    _build.check("hamming", code, "hamming_distance")
    return out


hamming_distance.launches = LaunchCount()
