"""In-memory hashing of a corpus into b-bit codes (counterpart of
``repro/data/hashed_dataset.py::preprocess_rows``).

The reference widens codes with its raw-minima encode (kernels B3/B4).
Until those are ported (ROADMAP A1), the port hashes each chunk with the
fused packed encode (B1 for minwise, B2 for OPH) through
``make_scheme(...).encode_packed`` and unpacks on the device.  For
b ∈ {1, 2, 4, 8} that gives the reference's integers.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.bbit import unpack_codes_torch
from repro_torch.core.schemes import make_scheme
from repro_torch.data.packing import pad_rows
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.kernels.fused_encode import PACK_BITS

PREPROCESS_SCHEMES = ("minwise", "oph")


def _length_sorted_chunks(rows: Sequence[np.ndarray],
                          chunk: int) -> Iterator[np.ndarray]:
    """Index arrays of ≤ ``chunk`` rows, shortest documents first, so a
    heavy-tailed corpus does not pad every chunk to its longest row."""
    order = np.argsort([len(r) for r in rows], kind="stable")
    for lo in range(0, len(rows), chunk):
        yield order[lo: lo + chunk]


def preprocess_rows(rows: Sequence[np.ndarray], k: int, b: int, *,
                    scheme: str = "minwise",
                    family: str = "multiply_shift", seed: int = 0,
                    chunk: int = 1024,
                    device: DeviceLike = None) -> np.ndarray:
    """Hashes rows → uint16 codes (n, k) on the host, the reference's
    integers.  ``scheme`` 'minwise' (k hash evaluations per nonzero) or
    'oph' (one, densified), ``family`` 'multiply_shift',
    b ∈ {1, 2, 4, 8}."""
    if (b not in PACK_BITS or scheme not in PREPROCESS_SCHEMES
            or family != "multiply_shift"):
        raise NotImplementedError(
            f"preprocess_rows(scheme={scheme!r}, family={family!r}, b={b}) "
            "needs the raw-minima encode kernels B3/B4, not ported yet "
            "(ROADMAP A1); the port covers scheme in "
            f"{PREPROCESS_SCHEMES}, family 'multiply_shift', b in "
            f"{PACK_BITS}")
    dev = resolve_device(device)
    sch = make_scheme(scheme, k, seed)
    out = np.empty((len(rows), k), dtype=np.uint16)
    for sel in _length_sorted_chunks(rows, chunk):
        idx, nnz = pad_rows([rows[i] for i in sel], bucket=True)
        packed, _ = sch.encode_packed(torch.from_numpy(idx).to(dev),
                                      torch.from_numpy(nnz).to(dev), b)
        codes = unpack_codes_torch(packed, k, b).to(torch.int32)
        out[sel] = codes.cpu().numpy().astype(np.uint16)
    return out
