"""b-bit codes with class structure, for the TRON cells.

Each class has a prototype row of k codes.  A document of class c with
resemblance r to its class copies each of its k codes from c's prototype
with probability r and otherwise draws it uniformly from [0, 2^b): the
law of the b-bit minwise codes of a document whose resemblance to its
class centroid is r (a code of an unrelated document matches by chance
with probability 2^-b).  r is uniform on [r_low, r_high] per document,
and a share ``label_flip`` of the labels is flipped after the codes are
drawn, so the classes overlap.  The prototypes come from
``proto_seed``, the documents from ``seed``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from hashbench.gen import generator


def class_codes(n_docs: int, k: int, b: int, r_low: float, r_high: float,
                label_flip: float, proto_seed: int, seed: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (codes int32 (n_docs, k) in [0, 2^b), labels int32 (n_docs,) in
    {0, 1}), on ``device``; the same seeds give the same tensors."""
    v = 1 << b
    proto = torch.randint(0, v, (2, k), device=device, dtype=torch.int32,
                          generator=generator(proto_seed, "prototypes",
                                              device))
    g = generator(seed, "class_codes", device)
    label = torch.randint(0, 2, (n_docs,), generator=g, device=device,
                          dtype=torch.int32)
    r = r_low + (r_high - r_low) * torch.rand(n_docs, generator=g,
                                              device=device)
    copy = torch.rand((n_docs, k), generator=g, device=device) < r[:, None]
    codes = torch.randint(0, v, (n_docs, k), generator=g, device=device,
                          dtype=torch.int32)
    codes = torch.where(copy, proto[label.long()], codes)
    flip = torch.rand(n_docs, generator=g, device=device) < label_flip
    return codes.contiguous(), torch.where(flip, 1 - label, label)
