"""CUDA kernels for Hopper, their plain torch versions, and dispatch."""
