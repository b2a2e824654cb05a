"""Versioned serving weights (``WeightSet`` of ``repro/serving/reload.py``).

The engine's live weights are one immutable ``WeightSet``: a version
string and one params dict per replica device.  ``swap_weights``
builds a whole new set and publishes it with one reference assignment;
a micro-batch reads the reference once, so every score comes from
exactly one version.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple


@dataclasses.dataclass(frozen=True)
class WeightSet:
    """One immutable generation of serving weights: the version tag and
    the per-replica device-resident params (index-aligned with the
    engine's device list)."""
    version: str
    params: Tuple[Any, ...]
    created_at: float = 0.0

    def on(self, device_index: int) -> Any:
        return self.params[device_index]
