"""The loops that drive the program, one module a kind of traffic; a
traffic file names its loop (``"loop"``).  Each module has:

* ``setup(cell, seed, device) -> state``: makes the inputs from the seed
  on the device and warms up the cell's own shapes (all of it set-up);
* ``window(state, seconds, span) -> Window``: the timed loop;
* ``shapes(state) -> dict``: what the roofline counts need (traced runs);
* ``check(state) -> (readings, failed)``: the comparison with the plain
  reference of what the window produced, run after the window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class Window:
    metrics: Dict[str, float]   # end-to-end values, by metric name
    calls: int                  # timed calls completed (fits, passes)
    attempted: int              # answers the window produced
    wall_s: float
    values: Dict[str, list] = dataclasses.field(default_factory=dict)
