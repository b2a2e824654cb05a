"""The plain reference: what the program is compared with.

Straightforward PyTorch and NumPy, written from the semantics the
configurations state: the multiply-shift + fmix32 hash family, minwise
hashing and densified one permutation hashing with b-bit packing
(``hashing``), the b-bit linear model's products and the LIBLINEAR
objective in float64 (``linear``), and TRON (``tron``).  It imports
neither JAX nor anything of the program: it works the hash parameters
out again from the seed, and reads the program's outputs only to judge
them.
"""
