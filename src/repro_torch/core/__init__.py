"""Hash families, OPH, b-bit packing and the scheme registry."""
