"""Data helpers: row padding and the synthetic expanded-rcv1 corpus
(numpy, copied from the reference), hashing a corpus into b-bit codes and
the packed shard archive (``hashed_dataset``), and the batch stream and
prefetcher of the streaming trainer (``prefetch``)."""
