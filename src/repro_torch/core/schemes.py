"""Hashing-scheme registry: minwise vs OPH (counterpart of
``repro/core/schemes.py``).

A scheme turns padded sparse rows into b-bit codes:

    sch = make_scheme("oph", k=256, seed=0)
    codes, empty = sch.encode_device(idx, nnz, b=8)         # torch, device
    codes = sch.encode_padded(idx_np, nnz_np, b=8)          # numpy in/out
    packed, empty = sch.encode_packed(idx, nnz, b=8)        # torch, device
    packed, empty = sch.encode_packed_numpy(idx, nnz, b=8)  # numpy, host

``encode_device`` is the counterpart of the reference's
``encode_device``: the raw-minima kernels (B3 minwise, B4 OPH) through
``kernels.ops``, then densify or zero-coding and the b-bit mask, on the
tensors' device → int32 (n, k) codes and, for ``oph_zero``, a bool
empty mask.  ``encode_torch`` is the same arithmetic in plain torch
(the reference's ``encode_jnp``).  ``encode_padded`` returns the uint16
codes of ``preprocess_rows``, empty bins of ``oph_zero`` marked
``OPH_EMPTY_CODE``.  ``encode_packed`` is the counterpart of the
reference's ``encode_packed_jit``: the fused kernels (B1, B2).  There
``empty`` is the packbits empty-bin mask for ``oph_zero``, ``None``
otherwise.  Both device encodes pick their arm through the cost model
(``perf.choose``, ops ``encode`` and ``encode_packed``, at the shape
``{scheme, k, b, rows, nnz}``); ``use_kernel=False`` pins the plain arm,
which a CUDA tensor refuses where the kernel applies.
``encode_packed_numpy`` is the reference's host encode, copied; it gives
the same bytes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core.bbit import pack_codes
from repro_torch.core.minhash import minhash_torch
from repro_torch.core.oph import (OPH_EMPTY_CODE, OPHHash, densify_rotation,
                                  densify_rotation_numpy,
                                  oph_bin_minima_ragged_numpy,
                                  oph_bin_minima_torch, split_zero_codes)
from repro_torch.core.universal_hash import (MASK32, MultiplyShiftHash,
                                             _fmix32_numpy, int32_to_words)
from repro_torch import perf
from repro_torch.devices import DeviceLike, resolve_device
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

    # -- dispatch (routed through the cost model) ---------------------------

    def _encode_shape(self, indices: torch.Tensor, b: int) -> dict:
        return {"scheme": self.name, "k": self.k, "b": int(b),
                "rows": int(indices.shape[0]),
                "nnz": int(indices.shape[1])}

    def _dispatch(self, op: str, indices: torch.Tensor, b: int,
                  use_kernel: bool) -> Tuple[dict, Optional[str]]:
        """(the op's shape, the explicit arm): ``use_kernel=False`` pins
        the plain arm, refused on a card where the kernel applies; True
        leaves the choice to ``perf.choose``."""
        shape = self._encode_shape(indices, b)
        if use_kernel:
            return shape, None
        perf.refuse_plain_on_card(op, shape, indices.device,
                                  f"{self.name} encode(use_kernel=False)")
        return shape, "plain"

    def encode_torch(
        self, indices: torch.Tensor, mask: torch.Tensor, b: int,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Plain torch: int32 (n, m) ids + bool (n, m) mask → (codes
        int32 (n, k), bool empty mask or None), on their device."""
        raise NotImplementedError

    def encode_device(
        self, indices: torch.Tensor, nnz: torch.Tensor, b: int, *,
        use_kernel: bool = True,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """int32 (n, m) padded rows + int32 (n,) nnz → (codes int32
        (n, k), bool empty mask or None) through the raw-minima encode
        (B3, B4), on their device."""
        raise NotImplementedError

    def encode_padded(self, indices: np.ndarray, nnz: np.ndarray, b: int,
                      *, device: DeviceLike = None) -> np.ndarray:
        """One padded chunk → uint16 (n, k) codes on the host, encoded
        on ``device`` (default ``cuda:0``); zero-coded schemes mark empty
        bins with ``OPH_EMPTY_CODE``."""
        dev = resolve_device(device)
        codes, empty = self.encode_device(
            torch.as_tensor(np.asarray(indices, np.int32)).to(dev),
            torch.as_tensor(np.asarray(nnz, np.int32)).to(dev), b)
        out = codes.cpu().numpy().astype(np.uint16)
        if empty is not None:
            out[empty.cpu().numpy()] = OPH_EMPTY_CODE
        return out

    def encode_packed(
        self, indices: torch.Tensor, nnz: torch.Tensor, b: int, *,
        use_kernel: bool = True,
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

    def encode_torch(self, indices, mask, b):
        a, bv = self.hash_params(indices.device)
        z = minhash_torch(indices, mask, int32_to_words(a),
                          int32_to_words(bv))
        return (z & ((1 << b) - 1)).to(torch.int32), None

    def encode_device(self, indices, nnz, b, *, use_kernel=True):
        shape, impl = self._dispatch("encode", indices, b, use_kernel)
        a, bv = self.hash_params(indices.device)
        z = ops.minhash(indices, nnz, a, bv, shape=shape, impl=impl)
        return z & ((1 << b) - 1), None

    def encode_packed(self, indices, nnz, b, *, use_kernel=True):
        shape, impl = self._dispatch("encode_packed", indices, b,
                                     use_kernel)
        a, bv = self.hash_params(indices.device)
        return ops.minhash_packed(indices, nnz, a, bv, b, shape=shape,
                                  impl=impl), None

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

    def _finish(self, vals, empty, b):
        """int64 words (n, k) and their empty bins → (int32 codes, bool
        empty mask or None): densify, or keep the mask (zero-coding)."""
        self._check_b(b)
        if self.densify:
            vals, _ = densify_rotation(vals, empty)
        codes = (vals & ((1 << b) - 1)).to(torch.int32)
        return codes, (None if self.densify else empty)

    def encode_torch(self, indices, mask, b):
        a, bv = self.hash_params(indices.device)
        vals, empty = oph_bin_minima_torch(indices, mask, int32_to_words(a),
                                           int32_to_words(bv), self.k)
        return self._finish(vals, empty, b)

    def encode_device(self, indices, nnz, b, *, use_kernel=True):
        shape, impl = self._dispatch("encode", indices, b, use_kernel)
        a, bv = self.hash_params(indices.device)
        vals = int32_to_words(ops.oph(indices, nnz, a, bv, self.k,
                                      shape=shape, impl=impl))
        return self._finish(vals, vals == MASK32, b)

    def encode_packed(self, indices, nnz, b, *, use_kernel=True):
        self._check_b(b)
        shape, impl = self._dispatch("encode_packed", indices, b,
                                     use_kernel)
        a, bv = self.hash_params(indices.device)
        packed, empty = ops.oph_packed(indices, nnz, a, bv, self.k, b,
                                       densify=self.densify, shape=shape,
                                       impl=impl)
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
