"""Linear model over packed b-bit codes."""
