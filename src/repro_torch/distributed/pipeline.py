"""GPipe-style pipeline parallelism over a mesh axis (counterpart of
``repro/distributed/pipeline.py``).

The layer stack is split into S contiguous stages, one a rank of the
axis's process group; M microbatches stream through with point-to-point
handoffs (the reference's ``ppermute``).  With M microbatches the bubble
fraction is (S-1)/(M+S-1) — at S=2, M=8 that is 1/9.

The forward is a Python loop over M+S-1 ticks on local tensors (the
reference's ``lax.fori_loop`` inside ``shard_map``).  It is
differentiable: the handoff's backward sends the cotangent back to the
previous stage, and each stage's activations are recomputed in the
backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of the stage).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.tree import tree_map

__all__ = ["pipelined_apply"]


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank i of ``group`` sends ``x`` to rank i+step and returns what
    rank i−step sent (zeros where there is no such rank)."""
    import torch.distributed as dist
    s, me = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= me + step < s:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, me + step), group))
    if 0 <= me - step < s:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, me - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Handoff(torch.autograd.Function):
    """ppermute [(i, i+1)]: forward one stage on, cotangent one back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, +1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _FromLastStage(torch.autograd.Function):
    """The sum of every stage's ``x`` (only the last stage's is
    non-zero) on every stage.  The loss that reads it is one loss, held
    on every rank, so its cotangent passes back unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipelined_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                    group=None) -> torch.Tensor:
    """Runs the local stage over M microbatches with handoffs.

    ``stage_fn(stage_params, x) -> y`` of x's shape; ``stage_params`` a
    tree whose leaves lead with [n_stages_local=1]; ``x_micro`` (M,
    micro_batch, ...) the same on every stage.  Stage 0 consumes
    microbatch m at tick m, the last stage's outputs are collected and
    summed onto every stage.  Every stage calls it, and every stage
    backpropagates through its result (the same loss on each rank,
    counted once).  Returns (M, micro, ...).  ``group`` is the
    pipeline axis's process group (``None``: one stage)."""
    import torch.distributed as dist
    s = 1 if group is None else dist.get_world_size(group)
    sid = 0 if group is None else dist.get_rank(group)
    m = x_micro.shape[0]
    params = tree_map(lambda p: p[0], stage_params)

    def fn(p, x):
        return stage_fn(p, x)

    def run(x):
        if torch.is_grad_enabled():
            return torch_checkpoint.checkpoint(fn, params, x,
                                               use_reentrant=False)
        return fn(params, x)

    inflight = torch.zeros_like(x_micro[0])
    outputs = []
    for t in range(m + s - 1):
        if sid == 0:
            # the handoff's cotangent must flow on every stage, so that
            # every rank's backward makes the same sends and receives
            x_in = x_micro[min(t, m - 1)] + 0 * inflight
        else:
            x_in = inflight
        y = run(x_in)
        if t >= s - 1:
            outputs.append(y)
        if s > 1:
            inflight = _Handoff.apply(y, group)
    out = torch.stack(outputs)
    if s > 1:
        # only the last stage's outputs count; the others join with
        # zeros that still depend on their stage (see above)
        out = _FromLastStage.apply(out if sid == s - 1 else out * 0,
                                   group)
    return out
