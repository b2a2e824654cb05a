"""In-memory hashing of a corpus into b-bit codes (counterpart of
``repro/data/hashed_dataset.py::preprocess_rows`` and
``preprocess_rows_packed``).

``preprocess_rows`` takes the reference's route: each length-sorted
chunk goes through ``make_scheme(...).encode_device`` — the raw-minima
encode (B3 for minwise, B4 for OPH), then densify or zero-coding and the
b-bit mask on the device — for every scheme and every b ≤ 16.  The exact
families (``mod_prime``) take the reference's numpy path.
``preprocess_rows_packed`` streams the fused packed encode (B1, B2).
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bbit import bbit_codes, pack_codes, packed_width
from repro_torch.core.minhash import minhash_numpy
from repro_torch.core.schemes import make_scheme
from repro_torch.core.universal_hash import make_hash_family
from repro_torch.data.packing import pad_rows
from repro_torch.devices import DeviceLike, resolve_device


def _length_sorted_chunks(rows: Sequence[np.ndarray],
                          chunk: int) -> Iterator[np.ndarray]:
    """Index arrays of ≤ ``chunk`` rows, shortest documents first, so a
    heavy-tailed corpus does not pad every chunk to its longest row."""
    order = np.argsort([len(r) for r in rows], kind="stable")
    for lo in range(0, len(rows), chunk):
        yield order[lo: lo + chunk]


def _stream_encoded(rows: Sequence[np.ndarray], k: int, b: int, *,
                    scheme: str, family: str, seed: int, chunk: int,
                    packed: bool, dev: torch.device):
    """Yields (sel, codes, empty|None) per length-sorted chunk: uint8
    packed rows and the packbits empty mask (``packed=True``), or uint16
    codes with the ``OPH_EMPTY_CODE`` sentinel applied."""
    if scheme == "minwise" and family != "multiply_shift":
        # exact offline families (mod-prime / permutation): numpy path
        fam = make_hash_family(family, k, seed)
        for sel in _length_sorted_chunks(rows, chunk):
            idx, nnz = pad_rows([rows[i] for i in sel], pad_to_multiple=1)
            mask = np.arange(idx.shape[1])[None, :] < nnz[:, None]
            codes = bbit_codes(minhash_numpy(idx, mask, fam), b)
            yield sel, (pack_codes(codes, b) if packed else codes), None
        return
    if scheme != "minwise" and family != "multiply_shift":
        raise ValueError(f"scheme {scheme!r} only supports the "
                         "multiply_shift family")
    sch = make_scheme(scheme, k, seed)
    for sel in _length_sorted_chunks(rows, chunk):
        idx, nnz = pad_rows([rows[i] for i in sel], bucket=True)
        if packed:
            # the row count is bucketed too (a ragged last chunk → the
            # next power of two, nnz=0 filler rows that fall off below)
            n_pad = min(chunk, 1 << max(3, (len(sel) - 1).bit_length()))
            if n_pad > len(sel):
                idx = np.pad(idx, ((0, n_pad - len(sel)), (0, 0)))
                nnz = np.pad(nnz, (0, n_pad - len(sel)))
        if not packed:
            yield sel, sch.encode_padded(idx, nnz, b, device=dev), None
            continue
        pk, em = sch.encode_packed(torch.from_numpy(idx).to(dev),
                                   torch.from_numpy(nnz).to(dev), b)
        yield (sel, pk[: len(sel)].cpu().numpy(),
               None if em is None else em[: len(sel)].cpu().numpy())


def preprocess_rows(rows: Sequence[np.ndarray], k: int, b: int, *,
                    scheme: str = "minwise",
                    family: str = "multiply_shift", seed: int = 0,
                    chunk: int = 1024,
                    device: DeviceLike = None) -> np.ndarray:
    """Hashes rows → uint16 codes (n, k) on the host, the reference's
    integers.  ``scheme`` 'minwise' (k hash evaluations per nonzero),
    'oph' (one, densified) or 'oph_zero' (one, empty bins marked
    ``OPH_EMPTY_CODE``, so b ≤ 15); ``family`` 'multiply_shift', or for
    minwise the exact 'mod_prime'; 1 ≤ b ≤ 16.  Runs on ``device``
    (default ``cuda:0``)."""
    dev = resolve_device(device)
    out = np.empty((len(rows), k), dtype=np.uint16)
    for sel, codes, _ in _stream_encoded(
            rows, k, b, scheme=scheme, family=family, seed=seed,
            chunk=chunk, packed=False, dev=dev):
        out[sel] = codes
    return out


def preprocess_rows_packed(
    rows: Sequence[np.ndarray], k: int, b: int, *,
    scheme: str = "minwise", family: str = "multiply_shift", seed: int = 0,
    chunk: int = 1024, device: DeviceLike = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Fused streaming encode → (packed uint8 (n, ceil(k·b/8)), packbits
    empty mask (n, ceil(k/8)) for ``oph_zero``, else None): the bytes of
    ``pack_codes(preprocess_rows(...), b)``, with only the packed rows
    leaving the device.  Runs on ``device`` (default ``cuda:0``)."""
    dev = resolve_device(device)
    out = np.empty((len(rows), packed_width(k, b)), dtype=np.uint8)
    emp: Optional[np.ndarray] = None
    for sel, pk, em in _stream_encoded(
            rows, k, b, scheme=scheme, family=family, seed=seed,
            chunk=chunk, packed=True, dev=dev):
        out[sel] = pk
        if em is not None:
            if emp is None:
                emp = np.zeros((len(rows), (k + 7) // 8), dtype=np.uint8)
            emp[sel] = em
    return out, emp
