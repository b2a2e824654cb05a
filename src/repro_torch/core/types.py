"""Shared data containers for the hashing/learning pipeline (counterpart
of ``repro/core/types.py``).

The paper's data model is *sparse binary* vectors (sets of nonzero
feature indices).  A batch of such sets is padded index rows plus a
validity mask (fixed shapes, no ragged buffers).  An optional ``values``
field carries real-valued features for the VW / random-projection
baselines, which are not restricted to binary data (paper §5).  A plain
dataclass of torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device


@dataclasses.dataclass
class SparseBatch:
    """A batch of sparse (binary or weighted) feature vectors.

    Attributes:
      indices: int32 (n, max_nnz) feature ids; padded entries arbitrary.
      mask:    bool  (n, max_nnz) True for valid entries.
      values:  optional float32 (n, max_nnz); None means binary data.
      dim:     the ambient dimensionality D.
    """

    indices: torch.Tensor
    mask: torch.Tensor
    values: Optional[torch.Tensor] = None
    dim: int = 0

    @property
    def n(self) -> int:
        return self.indices.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.indices.shape[1]

    def nnz(self) -> torch.Tensor:
        """int32 (n,) valid entries a row."""
        return self.mask.sum(dim=1, dtype=torch.int32)

    @classmethod
    def from_lists(
        cls,
        rows: Sequence[Sequence[int]],
        dim: int,
        values: Optional[Sequence[Sequence[float]]] = None,
        max_nnz: Optional[int] = None,
        pad_to_multiple: int = 8,
        device: DeviceLike = None,
    ) -> "SparseBatch":
        """Builds a padded batch from python lists of nonzero indices, on
        ``device`` (default ``cuda:0``)."""
        dev = resolve_device(device)
        n = len(rows)
        m = max((len(r) for r in rows), default=1)
        m = max(m, 1)
        if max_nnz is not None:
            m = max_nnz
        if pad_to_multiple > 1:
            m = ((m + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
        idx = np.zeros((n, m), dtype=np.int32)
        msk = np.zeros((n, m), dtype=bool)
        val = np.zeros((n, m), dtype=np.float32) if values is not None else None
        for i, r in enumerate(rows):
            r = list(r)[:m]
            idx[i, : len(r)] = np.asarray(r, dtype=np.int32)
            msk[i, : len(r)] = True
            if values is not None:
                v = list(values[i])[:m]
                val[i, : len(v)] = np.asarray(v, dtype=np.float32)
        return cls(
            indices=torch.from_numpy(idx).to(dev),
            mask=torch.from_numpy(msk).to(dev),
            values=None if val is None else torch.from_numpy(val).to(dev),
            dim=dim,
        )

    def to_dense(self) -> torch.Tensor:
        """Materializes the batch as a dense (n, dim) float32 matrix.

        Only for tests / small benchmarks — never for the real pipeline.
        """
        vals = (self.values if self.values is not None
                else torch.ones(self.indices.shape, dtype=torch.float32,
                                device=self.indices.device))
        vals = torch.where(self.mask, vals, 0.0)
        out = torch.zeros((self.n, self.dim), dtype=torch.float32,
                          device=self.indices.device)
        rows = torch.arange(self.n, device=self.indices.device)[:, None]
        rows = rows.expand(self.indices.shape)
        # padded entries add 0.0 at (row, idx): binary data never repeats
        # an index, and adding zero changes nothing
        return out.index_put_((rows, self.indices.to(torch.int64)), vals,
                              accumulate=True)


def resemblance(a: set, b: set) -> float:
    """Exact resemblance R = |A∩B| / |A∪B| (paper Eq. before (1))."""
    if not a and not b:
        return 1.0
    return len(a & b) / float(len(a | b))
