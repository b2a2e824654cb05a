"""Solvers: TRON (LIBLINEAR's trust-region Newton method), SGD and AdamW,
learning-rate schedules and Polyak tail averaging."""
