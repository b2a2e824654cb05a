"""Training: the LIBLINEAR objectives, metrics and the TRON trainers of
the paper's experiment; minibatch SGD steps, the in-memory SGD baseline,
the streaming trainer over packed shards and its restart supervisor."""
