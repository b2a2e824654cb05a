"""Input generators: everything a run feeds the program is made here from
``--seed``, on the run's device, in a few large calls."""
from __future__ import annotations

import zlib

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of a run's ``--seed``:
    any whole number, negative or past 64 bits included."""
    words = np.random.SeedSequence(
        [int(seed) % (1 << 64), zlib.crc32(tag.encode())]).generate_state(
            2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & ((1 << 63) - 1)


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    """A torch generator on ``device`` seeded with ``sub_seed(seed, tag)``."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g
