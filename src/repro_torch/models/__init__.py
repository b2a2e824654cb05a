"""Linear models over b-bit codes and over VW sketches."""
