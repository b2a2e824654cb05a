"""Distributed runtime over ``torch.distributed`` (the reference's
``repro/distributed``): processes and their groups, the LM zoo's
shardings on a ``DeviceMesh`` (DTensor), error-feedback gradient
compression, sequence and pipeline parallelism, and the collectives with
their record (the dp step's own calls, or a traced step's)."""
from repro_torch.distributed.collectives import (
    COLLECTIVE_OPS, all_gather_stacked, collective_bytes,
    collective_bytes_from_trace, collective_stats,
    collective_stats_from_trace, psum, psum_mean, reset_collective_stats,
)
from repro_torch.distributed.pipeline import pipelined_apply
from repro_torch.distributed.sequence_parallel import (
    merge_partial_attention, seq_parallel_ssm_scan,
)
from repro_torch.distributed.shardings import (
    P, batch_spec, constrain, data_axes, dp_size, mp_size, replicated,
    shard,
)
from repro_torch.distributed.grad_compression import (
    compressed_allreduce_mean, init_error_state,
    tree_compressed_allreduce_mean,
)
from repro_torch.distributed.runtime import (
    DataMesh, ProcessRuntime, current_rank, current_runtime, heartbeat,
    init_runtime, mesh_over_processes, process_devices, process_slot_range,
    read_heartbeats, replicate_across_processes, shutdown_runtime,
)

__all__ = [
    "ProcessRuntime", "DataMesh", "init_runtime", "shutdown_runtime",
    "current_runtime", "current_rank", "process_devices",
    "mesh_over_processes", "process_slot_range",
    "replicate_across_processes", "heartbeat", "read_heartbeats",
    "P", "data_axes", "batch_spec", "replicated", "shard", "dp_size",
    "mp_size", "constrain",
    "compressed_allreduce_mean", "tree_compressed_allreduce_mean",
    "init_error_state",
    "merge_partial_attention", "seq_parallel_ssm_scan",
    "pipelined_apply",
    "psum", "psum_mean", "all_gather_stacked", "collective_stats",
    "collective_bytes", "reset_collective_stats", "COLLECTIVE_OPS",
    "collective_stats_from_trace", "collective_bytes_from_trace",
]
