"""Data helpers: row padding and the synthetic expanded-rcv1 corpus
(numpy, copied from the reference), and in-memory hashing of a corpus
into b-bit codes (``hashed_dataset.preprocess_rows`` and
``preprocess_rows_packed``)."""
