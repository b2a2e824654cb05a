"""Mesh and sharding helpers of the LM zoo (counterpart of
``repro/distributed/shardings.py``).

Axis convention (the reference's production mesh):
  single-pod:  (data=16, model=16)
  multi-pod:   (pod=2, data=16, model=16)

"Batch-like" tensors shard over ``(pod, data)``; "model-like" dims over
``model``.  FSDP-style parameter sharding also splits the largest
parameter dim over the data axes.

JAX's ``NamedSharding`` becomes DTensor here.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are
the reference's axis names.  ``P`` is the reference's ``PartitionSpec``:
one entry per tensor dim, each ``None``, an axis name, or a tuple of
axis names.  ``placements(mesh, spec)`` turns it into one DTensor
placement per mesh dimension, and every module of the port goes through
it.  An entry that names several axes, such as ``("pod", "data")``,
shards its dim over all of them, the first axis major: DTensor nests
``Shard`` placements left to right over the mesh's dims, which is how
JAX tiles such an entry, so the axes must come in the mesh's order.

``shard_map`` becomes ``local_apply``: its arguments are redistributed
to the given specs, the function runs on the local shards, and the
result comes back as a DTensor (optionally a partial sum over some axes,
which a later ``redistribute`` all-reduces).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Sequence, Tuple

import torch

__all__ = ["P", "NamedSharding", "data_axes", "batch_spec", "replicated",
           "shard", "dp_size", "mp_size", "constrain", "placements",
           "axis_size", "distribute", "local_apply", "is_dtensor",
           "spec_map", "spec_leaves", "implicit_replication",
           "gather_fsdp", "divisible_spec", "local_calls_through"]


class P(tuple):
    """A partition spec: ``P(None, ("pod", "data"), "model")``.
    ``tuple(spec)`` gives its entries, as the reference's does."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(axis_names(mesh).index(axis)))


def divisible_spec(shape, mesh, spec) -> tuple:
    """``spec``'s entries for a tensor of ``shape``, each dropped (None)
    where the product of its axes' sizes does not divide its dim (odd
    vocabs, k=500, batch-1 caches, heads that 'model' does not divide);
    an axis the mesh lacks counts 1, and so does every axis with no
    mesh.  Padded with None to the tensor's rank."""
    names = axis_names(mesh) if mesh is not None else ()
    fixed = []
    for dim, entry in zip(shape, spec):
        size = 1
        for a in _axes(entry):
            size *= axis_size(mesh, a) if a in names else 1
        fixed.append(entry if entry not in (None, ()) and dim % size == 0
                     else None)
    return tuple(fixed) + (None,) * (len(shape) - len(fixed))


def data_axes(mesh) -> Tuple[str, ...]:
    """All batch-parallel axes present in the mesh ('pod' first)."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def batch_spec(mesh, extra_dims: int = 1) -> P:
    """P((pod, data), None, ...) for a batch-leading tensor."""
    return P(data_axes(mesh), *([None] * extra_dims))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard(mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, P(*axes))


def dp_size(mesh) -> int:
    out = 1
    for a in data_axes(mesh):
        out *= axis_size(mesh, a)
    return out


def mp_size(mesh) -> int:
    return axis_size(mesh, "model") if "model" in axis_names(mesh) else 1


def placements(mesh, spec, partial: Sequence[str] = ()) -> list:
    """One DTensor placement per mesh dim for ``spec`` (a ``P``, a tuple
    of entries, or ``None`` for replicated); the axes in ``partial`` hold
    a pending sum.  An axis named twice, an axis the mesh lacks, or a
    multi-axis entry out of the mesh's order raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    seen = set()
    for dim, entry in enumerate(tuple(spec or ())):
        axes = _axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}; the mesh "
                                 f"has {names}")
            if a in seen:
                raise ValueError(f"spec {spec!r} names axis {a!r} twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} lists its axes out of the mesh's "
                f"order {names}: DTensor tiles a dim over several mesh "
                "dims in mesh order only")
        for j in idx:
            out[j] = Shard(dim)
    for a in partial:
        j = names.index(a)
        if a in seen:
            raise ValueError(f"axis {a!r} is both sharded and partial")
        out[j] = Partial("sum")
    return out


@contextlib.contextmanager
def implicit_replication():
    """DTensor's ``implicit_replication`` (plain tensors in a DTensor op
    count as replicated), safe to nest: torch's own context resets the
    switch to off on exit, even inside an outer one."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    if not hasattr(disp, "_allow_implicit_replication"):
        from torch.distributed.tensor.experimental import \
            implicit_replication as torch_ir
        with torch_ir():
            yield
        return
    before = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = before


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def distribute(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``x`` (the same full value on every rank) as a DTensor of ``spec``:
    each rank keeps its shard, nothing is sent.  A DTensor is
    redistributed instead."""
    from torch.distributed.tensor import distribute_tensor
    pl = placements(mesh, spec)
    if is_dtensor(x):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def constrain(x, mesh, *axes):
    """``with_sharding_constraint`` shorthand: ``x`` redistributed to
    P(*axes); a plain tensor is taken as replicated first."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements(mesh, P(*axes)))


_LOCAL_RUNNER = contextvars.ContextVar("local_runner", default=None)


@contextlib.contextmanager
def local_calls_through(runner: Callable):
    """Inside the block, ``local_apply`` calls its local function as
    ``runner(fn, local_args)`` instead of ``fn(*local_args)`` (a tracer
    counting the local calls installs one; ``launch/roofline.py``)."""
    token = _LOCAL_RUNNER.set(runner)
    try:
        yield
    finally:
        _LOCAL_RUNNER.reset(token)


def gather_fsdp(w, mesh):
    """A weight with its shards over the data axes gathered (ZeRO-3's
    just-in-time all-gather), its 'model' shards kept; the backward
    reduce-scatters the gradient back over the data axes.  A plain
    tensor, or no mesh, passes as it is."""
    if mesh is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = axis_names(mesh)
    data = set(data_axes(mesh))
    pl = [Replicate() if names[i] in data else p
          for i, p in enumerate(w.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(mesh, pl)


def local_apply(fn: Callable, mesh, in_specs: Sequence, out_specs,
                *args, out_partial: Sequence[str] = (),
                grad_partial: Sequence[str] = ()):
    """The reference's ``shard_map`` on DTensors: every tensor argument
    is redistributed to its spec in ``in_specs`` (a plain tensor is taken
    as replicated; a ``None`` spec passes the argument as it is), ``fn``
    runs on the local shards, and each tensor it returns becomes a
    DTensor of its spec in ``out_specs`` (with ``out_partial``'s axes a
    pending sum).  Autograd flows through (``to_local`` /
    ``from_local``).  ``grad_partial`` names the axes along which ``fn``
    computes differently on each rank (it reads sharded data or the
    axis index there): an argument replicated along such an axis gets
    the sum of the ranks' gradients (JAX's transpose of a replicated
    ``shard_map`` input); along any other axis the ranks compute the
    same and one rank's gradient is the gradient."""
    from torch.distributed.tensor import DTensor, Partial
    names = axis_names(mesh)
    local = []
    for a, spec in zip(args, in_specs):
        if spec is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        d = constrain(a, mesh, *spec)
        gp = list(d.placements)
        for ax in grad_partial:
            j = names.index(ax)
            if gp[j].is_replicate():
                gp[j] = Partial("sum")
        local.append(d.to_local(grad_placements=gp))
    runner = _LOCAL_RUNNER.get()
    out = fn(*local) if runner is None else runner(fn, local)
    single = isinstance(out, torch.Tensor)
    outs = (out,) if single else tuple(out)
    specs = (out_specs,) if single else tuple(out_specs)
    wrapped = tuple(
        DTensor.from_local(o, mesh, placements(mesh, s, out_partial),
                           run_check=False)
        if isinstance(o, torch.Tensor) and s is not None else o
        for o, s in zip(outs, specs))
    return wrapped[0] if single else wrapped


def spec_map(fn: Callable, tree, *rest):
    """``jax.tree.map`` over a tree of specs: a ``P`` (or ``None``) is a
    leaf; dicts, lists, tuples and dataclasses (``QuantizedArray``) are
    nodes.  ``rest`` are trees of the same structure, walked along."""
    if isinstance(tree, P) or tree is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: spec_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(spec_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def spec_leaves(tree) -> list:
    """The specs of a spec tree in the reference's leaf order (dict
    keys sorted, as ``repro_torch.tree.leaves``)."""
    if isinstance(tree, P) or tree is None:
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in spec_leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in spec_leaves(v)]
    return [tree]


def group_of(mesh, axis: str):
    """The process group of one mesh axis (for a collective on local
    shards inside ``local_apply``)."""
    return mesh.get_group(axis)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))
