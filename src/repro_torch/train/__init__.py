"""Training: the LIBLINEAR objectives, metrics and the TRON trainers of
the paper's experiment."""
