"""Multi-process data-parallel training over ``torch.distributed``: the
runtime and its process groups, the dp step's collectives and their
record, and error-feedback gradient compression (the reference's
``repro/distributed`` without its LM-zoo parts: ``shardings``,
``sequence_parallel`` and ``pipeline`` belong to ROADMAP A6c)."""
from repro_torch.distributed.collectives import (
    COLLECTIVE_OPS, all_gather_stacked, collective_bytes, collective_stats,
    psum, psum_mean, reset_collective_stats,
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
    "compressed_allreduce_mean", "tree_compressed_allreduce_mean",
    "init_error_state",
    "psum", "psum_mean", "all_gather_stacked", "collective_stats",
    "collective_bytes", "reset_collective_stats", "COLLECTIVE_OPS",
]
