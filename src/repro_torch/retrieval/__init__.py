"""Banded LSH retrieval over packed b-bit codes (counterpart of
``repro/retrieval``): band keys straight from the packed bytes
(``bands``, numpy, copied) and a banded inverted index whose candidates
are ranked by packed Hamming similarity on the card (``index``, kernel
B10 through ``kernels.ops.hamming_topk``)."""
from repro_torch.retrieval.bands import (band_geometry, band_keys_packed,
                                         band_keys_ref, band_signature)
from repro_torch.retrieval.index import BandedLSHIndex

__all__ = [
    "BandedLSHIndex",
    "band_geometry",
    "band_keys_packed",
    "band_keys_ref",
    "band_signature",
]
