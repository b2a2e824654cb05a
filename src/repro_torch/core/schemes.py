"""Hashing-scheme registry: minwise vs OPH (counterpart of
``repro/core/schemes.py``, serving path).

A scheme turns padded sparse rows into packed b-bit codes:

    sch = make_scheme("oph", k=256, seed=0)
    packed, empty = sch.encode_packed(idx, nnz, b=8)        # torch, device
    packed, empty = sch.encode_packed_numpy(idx, nnz, b=8)  # numpy, host

``encode_packed`` is the counterpart of the reference's
``encode_packed_jit``: the fused kernels (B1, B2) through
``kernels.ops`` on the tensors' device.  ``empty`` is the packbits
empty-bin mask for the zero-coded ``oph_zero`` scheme, ``None``
otherwise.  ``encode_packed_numpy`` is the reference's host encode,
copied; both give the same bytes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core.bbit import pack_codes
from repro_torch.core.oph import (OPH_EMPTY_CODE, OPHHash,
                                  densify_rotation_numpy,
                                  oph_bin_minima_ragged_numpy,
                                  split_zero_codes)
from repro_torch.core.universal_hash import MultiplyShiftHash, _fmix32_numpy
from repro_torch.kernels import ops

SCHEMES: Dict[str, Type["HashingScheme"]] = {}


def register_scheme(name: str):
    def deco(cls):
        cls.name = name
        SCHEMES[name] = cls
        return cls
    return deco


def make_scheme(name: str, k: int, seed: int) -> "HashingScheme":
    if name not in SCHEMES:
        raise ValueError(
            f"unknown hashing scheme {name!r}; have {sorted(SCHEMES)}")
    return SCHEMES[name](k=k, seed=seed)


class HashingScheme:
    """Base: sparse rows → packed b-bit codes."""

    name: str = "?"

    def __init__(self, k: int, seed: int):
        self.k = k
        self.seed = seed
        self.family = None
        self._params: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def hash_params(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The family's (a, b) int32 words, kept resident per device."""
        device = torch.device(device)
        got = self._params.get(device)
        if got is None:
            got = self.family.params(device)
            self._params[device] = got
        return got

    def encode_packed(
        self, indices: torch.Tensor, nnz: torch.Tensor, b: int,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """int32 (n, m) padded rows + int32 (n,) nnz → (packed uint8
        (n, ceil(k·b/8)), packbits empty mask or None), on their device."""
        raise NotImplementedError

    def encode_packed_numpy(
        self, indices: np.ndarray, nnz: np.ndarray, b: int,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Host twin of ``encode_packed``: the same bytes, in numpy."""
        raise NotImplementedError


@register_scheme("minwise")
class MinwiseScheme(HashingScheme):
    """The paper's scheme: k independent multiply-shift permutations."""

    def __init__(self, k: int, seed: int):
        super().__init__(k, seed)
        self.family = MultiplyShiftHash.make(k, seed)

    def encode_packed(self, indices, nnz, b):
        a, bv = self.hash_params(indices.device)
        return ops.minhash_packed(indices, nnz, a, bv, b), None

    # k-chunking bounds the (n, m, chunk) intermediate
    _NUMPY_K_CHUNK = 64

    def encode_packed_numpy(self, indices, nnz, b):
        indices = np.asarray(indices)
        n, m = indices.shape
        mask = (np.arange(m, dtype=np.int64)[None, :]
                < np.asarray(nnz, dtype=np.int64)[:, None])
        t = indices.astype(np.uint32)[:, :, None]
        a_np = np.asarray(self.family.a, dtype=np.uint32)
        b_np = np.asarray(self.family.b, dtype=np.uint32)
        z = np.empty((n, self.k), dtype=np.uint32)
        sentinel = np.uint32(0xFFFFFFFF)
        for lo in range(0, self.k, self._NUMPY_K_CHUNK):
            hi = min(lo + self._NUMPY_K_CHUNK, self.k)
            h = _fmix32_numpy(a_np[None, None, lo:hi] * t
                              + b_np[None, None, lo:hi])
            z[:, lo:hi] = np.where(mask[:, :, None], h, sentinel).min(axis=1)
        codes = (z & np.uint32((1 << b) - 1)).astype(np.uint16)
        return pack_codes(codes, b), None


@register_scheme("oph")
class OPHScheme(HashingScheme):
    """One-permutation hashing, densified by rotation: k valid codes
    from one hash evaluation per nonzero."""

    densify: bool = True

    def __init__(self, k: int, seed: int):
        super().__init__(k, seed)
        self.family = OPHHash.make(k, seed)

    def _check_b(self, b: int) -> None:
        if not self.densify and b > 15:
            raise ValueError("oph_zero reserves 0xFFFF: b must be <= 15")

    def encode_packed(self, indices, nnz, b):
        self._check_b(b)
        a, bv = self.hash_params(indices.device)
        packed, empty = ops.oph_packed(indices, nnz, a, bv, self.k, b,
                                       densify=self.densify)
        return packed, (None if self.densify else empty)

    def encode_packed_numpy(self, indices, nnz, b):
        indices = np.asarray(indices)
        n, m = indices.shape
        lens = np.minimum(np.asarray(nnz, dtype=np.int64), m)
        mask = np.arange(m, dtype=np.int64)[None, :] < lens[:, None]
        return self.encode_packed_numpy_ragged(indices[mask], lens, b)

    def encode_packed_numpy_ragged(self, tokens, lens, b):
        """Host encode of the row-major concat ``tokens`` of every doc's
        nonzeros with per-doc counts ``lens``."""
        self._check_b(b)
        vals, empty = oph_bin_minima_ragged_numpy(tokens, lens, self.family)
        if self.densify:
            # densify is the identity on rows with no empty bin
            need = empty.any(axis=1)
            if need.any():
                sub_vals, sub_empty = densify_rotation_numpy(
                    vals[need], empty[need])
                vals[need] = sub_vals
                empty[need] = sub_empty
        codes = (vals & np.uint32((1 << b) - 1)).astype(np.uint16)
        codes = np.where(empty, OPH_EMPTY_CODE, codes)
        if self.densify:
            # all-empty rows keep OPH_EMPTY_CODE → all-ones low b bits
            return pack_codes(codes, b), None
        codes0, empty = split_zero_codes(codes)
        return pack_codes(codes0, b), np.packbits(empty, axis=1)


@register_scheme("oph_zero")
class OPHZeroScheme(OPHScheme):
    """Zero-coded OPH: empty bins carry no signal (empty mask)."""

    densify = False
