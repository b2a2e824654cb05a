"""Solvers: TRON, LIBLINEAR's trust-region Newton method."""
