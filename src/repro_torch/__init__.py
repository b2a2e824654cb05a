"""PyTorch + CUDA port of the b-bit hashed classifier: serving, the
paper's experiment (TRON over b-bit codes and over VW sketches) and
banded-LSH search over packed codes.

A second package beside the JAX reference ``repro``: the same hashing
schemes, packed code layout and (k, 2^b, C) linear table, served by
``repro_torch.serving.HashedClassifierEngine``, trained by
``repro_torch.train.linear_trainer`` and searched by
``repro_torch.retrieval.BandedLSHIndex`` through hand-written CUDA
kernels for Hopper (``repro_torch/csrc``).  It imports torch and
numpy only.  Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; the CPU runs each kernel's plain torch version.
"""
