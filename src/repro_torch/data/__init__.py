"""Data helpers: row padding and the synthetic expanded-rcv1 corpus
(numpy, copied from the reference), LIBSVM files, hashing a corpus into
b-bit codes and the packed shard archive (``hashed_dataset``), the batch
stream and prefetcher of the streaming trainer (``prefetch``) and the
in-memory loaders, and the LM zoo's synthetic token streams
(``lm_synth``, numpy, copied) (counterpart of ``repro/data``)."""
from repro_torch.data.hashed_dataset import (HashedShardWriter,
                                             ShardCorruptionError,
                                             ShardReadError, iter_hashed,
                                             iter_hashed_batches,
                                             iter_packed, load_hashed,
                                             load_packed_shard,
                                             preprocess_and_save,
                                             preprocess_rows,
                                             preprocess_rows_packed,
                                             save_hashed, shard_row_counts,
                                             verify_shard)
from repro_torch.data.libsvm_io import (read_libsvm, read_shards,
                                        shard_paths, write_libsvm,
                                        write_shards)
from repro_torch.data.lm_synth import lm_example_stream, token_batch
from repro_torch.data.loader import HashedCodesLoader, SparseRowsLoader
from repro_torch.data.packing import batch_iterator, bucket_width, pad_rows
from repro_torch.data.prefetch import (Boundary, ShardStreamError,
                                       StreamBatch, ThreadedPrefetcher,
                                       group_batch_stream,
                                       serial_batch_stream, shard_order)
from repro_torch.data.synth_rcv1 import (SynthRcv1Config, generate,
                                         generate_arrays)

__all__ = [
    "SynthRcv1Config", "generate", "generate_arrays",
    "write_libsvm", "read_libsvm", "write_shards", "read_shards",
    "shard_paths",
    "pad_rows", "batch_iterator", "bucket_width",
    "preprocess_rows", "preprocess_rows_packed", "save_hashed",
    "load_hashed", "iter_hashed", "iter_packed", "iter_hashed_batches",
    "load_packed_shard", "shard_row_counts", "preprocess_and_save",
    "verify_shard", "HashedShardWriter", "ShardCorruptionError",
    "ShardReadError",
    "StreamBatch", "Boundary", "ShardStreamError", "shard_order",
    "serial_batch_stream", "group_batch_stream", "ThreadedPrefetcher",
    "HashedCodesLoader", "SparseRowsLoader",
    "token_batch", "lm_example_stream",
]
