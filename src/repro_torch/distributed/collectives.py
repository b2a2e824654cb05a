"""The data-parallel step's collectives over a ``torch.distributed``
group, and the record of what they moved (counterpart of
``repro/distributed/collectives.py``).

``psum``, ``psum_mean`` and ``all_gather_stacked`` are the only
collectives of the dp step (``train.data_parallel``,
``distributed.grad_compression``).
Each call is recorded as ``{"op", "bytes", "group_size"}``, the record
of the reference's ``collective_stats_from_hlo``: ``bytes`` is the
result that lands on each participant.  A call without a group (one
process holding the whole data world) is the identity and is recorded
with ``group_size`` 1, so a single-process run still shows the bytes its
step would put on the wire.  ``collective_bytes()`` sums the record in
the dict shape of ``collective_bytes_from_hlo``.

The reference's two HLO-text parsers (``collective_stats_from_hlo``,
``collective_bytes_from_hlo``) read the collectives of an XLA program.
Their counterparts here read the functional collectives that one traced
call of a step dispatched (``launch/roofline.py::trace_step``):
``collective_stats_from_trace`` gives the same ``{"op", "bytes",
"group_size"}`` records (bytes: the result that lands on each
participant) and ``collective_bytes_from_trace`` their sums.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import torch

from repro_torch import tree as _tree

__all__ = ["COLLECTIVE_OPS", "psum", "psum_mean", "all_gather_stacked",
           "group_size", "collective_stats", "collective_bytes",
           "reset_collective_stats", "collective_stats_from_trace",
           "collective_bytes_from_trace"]

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_RECORD: List[dict] = []
_RECORD_LOCK = threading.Lock()


def _record(op: str, nbytes: int, size: int) -> None:
    with _RECORD_LOCK:
        _RECORD.append({"op": op, "bytes": int(nbytes),
                        "group_size": int(size)})


def collective_stats() -> List[dict]:
    """Every collective recorded since the last reset, in call order."""
    with _RECORD_LOCK:
        return [dict(r) for r in _RECORD]


def collective_bytes() -> Dict[str, int]:
    """Bytes by op, ``count`` and ``total``, over the record."""
    out = {k: 0 for k in COLLECTIVE_OPS}
    out["count"] = 0
    for st in collective_stats():
        out[st["op"]] += st["bytes"]
        out["count"] += 1
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
    return out


def reset_collective_stats() -> None:
    with _RECORD_LOCK:
        _RECORD.clear()


def group_size(group) -> int:
    """Participants of ``group`` (1 without a group)."""
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def _fused_sum(tensors: Any, group, count: Optional[int]) -> Any:
    leaves = _tree.leaves(tensors)
    if not leaves:
        return tensors
    size = group_size(group)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, v in enumerate(leaves):
        groups.setdefault(v.dtype, []).append(i)
    out: List[Any] = [None] * len(leaves)
    for dt, idxs in groups.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        _record("all-reduce", flat.numel() * flat.element_size(), size)
        if group is not None:
            import torch.distributed as dist
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if count is not None:
            flat = flat / torch.tensor(count, dtype=dt, device=flat.device)
        off = 0
        for i in idxs:
            n_i = leaves[i].numel()
            out[i] = flat[off: off + n_i].reshape(leaves[i].shape)
            off += n_i
    return _tree.unflatten(tensors, out)


def psum(tensors: Any, group=None) -> Any:
    """Sum over the group of a tree of tensors (new tensors, the same
    structure), one ``all_reduce`` per dtype."""
    return _fused_sum(tensors, group, None)


def psum_mean(tensors: Any, group=None, *, count: Optional[int] = None
              ) -> Any:
    """Mean over the group of a tree of tensors (the same structure
    back, new tensors): the sum over the ranks divided by ``count``
    (default the group's size; the dp step passes its physical world when
    each rank contributes the sum of several devices).

      * each leaf keeps its dtype: the count is cast to the leaf's dtype
        before the divide, so bfloat16 stays bfloat16;
      * one ``all_reduce`` per dtype, not per leaf: same-dtype leaves
        are raveled, concatenated, reduced and split again.
    """
    return _fused_sum(tensors, group,
                      group_size(group) if count is None else int(count))


def all_gather_stacked(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked on a new leading axis in rank order
    (``t[None]`` without a group).  A backend that cannot gather this
    tensor raises: nothing here moves the gather elsewhere."""
    size = group_size(group)
    _record("all-gather", size * t.numel() * t.element_size(), size)
    if group is None:
        return t[None]
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


# the functional collectives a traced call dispatches, as the reference's
# HLO op names
_TRACE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _trace_group_size(name: str, args) -> int:
    """The group's size from a functional collective's arguments (the
    group name is the last string argument)."""
    group_name = [a for a in args if isinstance(a, str)][-1]
    from torch.distributed.distributed_c10d import _resolve_process_group
    return int(_resolve_process_group(group_name).size())


def collective_stats_from_trace(calls) -> List[dict]:
    """Per-call collective stats ``[{op, bytes, group_size}]`` from the
    ``(op name, args, result)`` triples of the ``_c10d_functional`` ops
    one traced call dispatched (``launch/roofline.py::trace_step``).
    ``bytes`` is the result landing on each participant, as in the
    reference's ``collective_stats_from_hlo``."""
    stats = []
    for name, args, out in calls:
        op = _TRACE_OPS.get(name)
        if op is None:
            continue
        outs = _tree.leaves(out)
        nbytes = sum(t.numel() * t.element_size() for t in outs
                     if isinstance(t, torch.Tensor))
        stats.append({"op": op, "bytes": int(nbytes),
                      "group_size": _trace_group_size(name, args)})
    return stats


def collective_bytes_from_trace(calls) -> Dict[str, int]:
    """Bytes by op, ``count`` and ``total`` over a traced call's
    collectives (the dict of ``collective_bytes_from_hlo``)."""
    out = {k: 0 for k in COLLECTIVE_OPS}
    out["count"] = 0
    for st in collective_stats_from_trace(calls):
        out[st["op"]] += st["bytes"]
        out["count"] += 1
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
    return out
