"""Sequence parallelism: long-context sharding over a mesh axis
(counterpart of ``repro/distributed/sequence_parallel.py``).

Two primitives, on local tensors inside ``shardings.local_apply`` (the
reference's ``shard_map`` bodies), with their collectives over the
process group of one mesh axis:

  * ``merge_partial_attention`` — distributed online softmax: each shard
    attends over its local KV slice; the partial (max, denom, numerator)
    stats merge with one all-reduce max and two all-reduce sums.  Exact,
    not approximate.  The port's decode step uses it when a KV cache is
    sharded over its sequence (``models/transformer.py``).
  * ``seq_parallel_ssm_scan`` — the inter-chunk SSM recurrence
    h' = A·h + B composed across shards: the per-shard cumulative (A, B)
    operators are all-gathered (batch × heads × state, tiny) and each
    shard applies its exclusive prefix locally.

``group`` is a ``torch.distributed`` process group (a mesh axis's:
``mesh.get_group("data")``) or ``None`` for a world of one, where both
reduce to the single-shard math.
"""
from __future__ import annotations

import torch

__all__ = ["merge_partial_attention", "seq_parallel_ssm_scan"]


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    if group is None:
        return x
    import torch.distributed._functional_collectives as funcol
    return funcol.all_reduce(x, op, group)


def _all_gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """(S, ...) with shard i's ``x`` at row i."""
    if group is None:
        return x[None]
    import torch.distributed._functional_collectives as funcol
    return funcol.all_gather_tensor(x[None].contiguous(), 0, group)


def merge_partial_attention(local_max: torch.Tensor,
                            local_denom: torch.Tensor,
                            local_num: torch.Tensor, group) -> torch.Tensor:
    """Exact softmax-attention output from per-shard partial stats:
    ``local_max`` (..., q) the shard's running max of the scores,
    ``local_denom`` (..., q) Σ exp(score − local_max), ``local_num``
    (..., q, d) Σ exp(score − local_max)·V.  A shard that saw no key has
    max −inf and contributes nothing."""
    g_max = _all_reduce(local_max, "max", group)
    corr = torch.where(torch.isfinite(local_max),
                       torch.exp(local_max - g_max),
                       torch.zeros_like(local_max))
    denom = _all_reduce(local_denom * corr, "sum", group)
    num = _all_reduce(local_num * corr[..., None], "sum", group)
    return num / denom[..., None]


def seq_parallel_ssm_scan(a_cum: torch.Tensor, b_cum: torch.Tensor,
                          h0: torch.Tensor, group,
                          axis_index: int) -> torch.Tensor:
    """Each shard's incoming state h_in.  The local chunk maps
    h_in → a_cum·h_in + b_cum (``a_cum``, ``b_cum`` (..., state)); the
    operators of all shards are gathered and the exclusive prefix from
    the global initial state ``h0`` composed locally, in shard order."""
    a_all = _all_gather_stacked(a_cum, group)
    b_all = _all_gather_stacked(b_cum, group)
    h = h0
    for i in range(int(axis_index)):
        h = a_all[i] * h + b_all[i]
    return h
