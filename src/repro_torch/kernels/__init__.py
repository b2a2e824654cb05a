"""CUDA kernels for Hopper, their plain torch versions, and dispatch.

Import ``repro_torch.kernels.ops`` for the dispatching public API and
``repro_torch.kernels.ref`` for the plain versions under the names of the
reference's oracles.  Importing builds nothing: each kernel is built at
its first launch (``_build``).
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
