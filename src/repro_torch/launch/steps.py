"""Distributed step builders: train / prefill / decode / linear steps over
DTensor-sharded state for any (arch × shape × mesh) cell (counterpart of
``repro/launch/steps.py``).

The reference returns ``jax.jit``-ed functions with explicit in/out
shardings.  Here a step is a plain callable over DTensors laid out by
the same partition specs (``distributed/shardings.py``): its arguments
are placed by the caller (``shard_tree``), it runs under DTensor's
implicit replication, and the train steps hand their state back in the
state's own layout.  The reference's ``donate_argnums`` becomes "the
state is updated in place": the train steps write params and moments in
place and return the same tensors, the decode step writes its KV cache
in place.

Shapes come from the meta device (``abstract_train_state``,
``param_shapes``): nothing is allocated, so the dry-run traces
kimi-k2's 1.04 T params; the launchers call the same builders with real
tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.rcv1_bbit import PaperConfig
from repro_torch.distributed import shardings as sh
from repro_torch.distributed.shardings import NamedSharding, P
from repro_torch.launch.shapes import CellPlan
from repro_torch.models.api import BatchShape, ModelAPI
from repro_torch.models.linear import BBitLinearConfig
from repro_torch.optim.optimizers import AdamWConfig, adamw
from repro_torch.optim.quantized_state import QuantizedArray, moment_pspec
from repro_torch.train.losses import mean_loss_fn
from repro_torch.train.steps import TrainState, init_state
from repro_torch.tree import leaves, paths, unflatten

__all__ = ["align_pspecs", "set_mesh_for_alignment", "to_shardings",
           "batch_pspecs", "make_optimizer_for", "abstract_train_state",
           "train_state_pspecs", "build_lm_train_step",
           "build_prefill_step", "build_decode_step",
           "build_linear_train_step", "shard_tree", "param_shapes"]


# ---------------------------------------------------------------------------
# pspec plumbing
# ---------------------------------------------------------------------------
def align_pspecs(tree: Any, pspec_tree: Any) -> Any:
    """A pspec tree structurally matching ``tree``.

    Walks both trees; wherever the pspec tree lacks an entry (or the
    rank differs) the leaf is replicated, and entries whose axes do not
    divide their dim are dropped (``_drop_indivisible``).  The leaves of
    ``tree`` are anything with a ``.shape`` (tensors, meta tensors,
    ``BatchShape``)."""
    def walk(node, spec):
        if isinstance(node, dict):
            spec = spec if isinstance(spec, dict) else {}
            return {k: walk(v, spec.get(k)) for k, v in node.items()}
        if isinstance(node, TrainState):
            spec = spec if isinstance(spec, TrainState) \
                else TrainState(None, None, None)
            return TrainState(walk(node.params, spec.params),
                              walk(node.opt_state, spec.opt_state),
                              walk(node.step, spec.step))
        if isinstance(node, QuantizedArray):
            if isinstance(spec, QuantizedArray):
                return QuantizedArray(q=walk(node.q, spec.q),
                                      scale=walk(node.scale, spec.scale))
            return QuantizedArray(q=walk(node.q, None),
                                  scale=walk(node.scale, None))
        if isinstance(node, (list, tuple)) and not isinstance(
                node, BatchShape):
            spec_seq = spec if isinstance(spec, (list, tuple)) and \
                not isinstance(spec, P) else [None] * len(node)
            return type(node)(walk(v, s) for v, s in zip(node, spec_seq))
        shape = tuple(getattr(node, "shape", ()))
        rank = len(shape)
        if isinstance(spec, P):
            entries = tuple(spec)
            if len(entries) < rank:
                entries = entries + (None,) * (rank - len(entries))
            elif len(entries) > rank:
                entries = entries[:rank]
            return P(*_drop_indivisible(shape, entries))
        return P(*([None] * rank))

    return walk(tree, pspec_tree)


_ALIGN_MESH: Dict[str, Any] = {}


def set_mesh_for_alignment(mesh) -> None:
    """The mesh that ``align_pspecs`` (whose signature is the
    reference's, without one) checks divisibility against."""
    _ALIGN_MESH["mesh"] = mesh


def _drop_indivisible(shape, entries):
    """Replace spec entries whose mesh-axis product doesn't divide the
    dim with replication (``shardings.divisible_spec`` on the alignment
    mesh)."""
    return sh.divisible_spec(shape, _ALIGN_MESH.get("mesh"), entries)


def to_shardings(mesh, pspec_tree: Any) -> Any:
    return sh.spec_map(lambda s: NamedSharding(mesh, s), pspec_tree)


def batch_pspecs(mesh, batch_shapes: Dict[str, Any]) -> Dict:
    dp = sh.data_axes(mesh)
    dp_size = sh.dp_size(mesh)
    out = {}
    for k, v in batch_shapes.items():
        rank = len(v.shape)
        # batch-1 cells (long_500k) can't shard the batch dim
        lead = dp if v.shape[0] % max(dp_size, 1) == 0 else None
        out[k] = P(lead, *([None] * (rank - 1)))
    return out


def shard_tree(tree: Any, spec_tree: Any, mesh) -> Any:
    """Every tensor leaf of ``tree`` (the same full value on every rank)
    as a DTensor of its spec in ``spec_tree`` (the structure
    ``align_pspecs`` gives); each rank keeps its own shard."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, TrainState):
            return TrainState(walk(node.params, spec.params),
                              walk(node.opt_state, spec.opt_state),
                              node.step)
        if isinstance(node, QuantizedArray):
            return QuantizedArray(q=walk(node.q, spec.q),
                                  scale=walk(node.scale, spec.scale))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s) for v, s in zip(node, spec))
        if isinstance(node, torch.Tensor):
            return sh.distribute(node, mesh, spec)
        return node
    return walk(tree, spec_tree)


def local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of every tensor leaf (a DTensor's
    local shard, a plain tensor whole)."""
    total = 0
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if sh.is_dtensor(leaf) else leaf
            total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# LM train step
# ---------------------------------------------------------------------------
def make_optimizer_for(cfg: ArchConfig):
    return adamw(3e-4, AdamWConfig(weight_decay=0.01, b2=0.95,
                                   moment_dtype=cfg.moment_dtype))


def param_shapes(api: ModelAPI):
    """The params' tree on the meta device (shapes and dtypes only)."""
    return api.init_params(None, device="meta")


def abstract_train_state(api: ModelAPI) -> TrainState:
    """The step-0 train state on the meta device: params, AdamW moments
    (int8 ``QuantizedArray``s where the config asks) and step."""
    return init_state(param_shapes(api), make_optimizer_for(api.cfg))


def train_state_pspecs(api: ModelAPI, mesh, state_shapes: TrainState):
    """The state's partition specs.  The port's optimizer keys its
    moments by the params' paths (``train/steps.py``), so ``m`` and
    ``v`` are flat dicts of the params' specs (``moment_pspec``)."""
    pp = align_pspecs(state_shapes.params, api.param_pspecs(mesh))
    md = api.cfg.moment_dtype
    moments = {n: moment_pspec(s, md) for n, s in
               zip(paths(state_shapes.params), sh.spec_leaves(pp))}
    opt_ps = align_pspecs(state_shapes.opt_state,
                          {"m": moments, "v": moments})
    return TrainState(params=pp, opt_state=opt_ps, step=P())


def _layouts(tree: Any) -> list:
    """(mesh, placements) of each DTensor leaf of ``tree``, None for any
    other leaf, in leaf order."""
    return [(t.device_mesh, tuple(t.placements)) if sh.is_dtensor(t)
            else None for t in leaves(tree)]


def _relayout(tree: Any, layouts: list) -> Any:
    """Each DTensor leaf of ``tree`` put back in its layout from
    ``_layouts`` (the reference's out_shardings)."""
    return unflatten(tree, [
        t.redistribute(*lay) if lay is not None and sh.is_dtensor(t)
        and tuple(t.placements) != lay[1] else t
        for t, lay in zip(leaves(tree), layouts)])


def _local_microbatches(x: torch.Tensor, n_micro: int):
    """A batch leaf split into ``n_micro`` microbatches along its leading
    dim, on each rank's own rows (a DTensor sharded over the data axes
    keeps that layout; every rank's microbatch i is a slice of its own
    shard)."""
    if not sh.is_dtensor(x):
        return list(x.reshape((n_micro, x.shape[0] // n_micro)
                              + tuple(x.shape[1:])))
    from torch.distributed.tensor import DTensor
    loc = x.to_local()
    if loc.shape[0] % n_micro:
        raise ValueError(f"n_micro={n_micro} does not divide the local "
                         f"batch of {loc.shape[0]}")
    chunk = loc.shape[0] // n_micro
    return [DTensor.from_local(loc[i * chunk:(i + 1) * chunk],
                               x.device_mesh, x.placements, run_check=False)
            for i in range(n_micro)]


def build_lm_train_step(api: ModelAPI, mesh, plan: CellPlan):
    """Returns (step, state_shapes, state_pspecs, batch_shapes,
    batch_pspecs); ``step(state, batch) -> (state, loss)``.

    Gradients accumulate over ``plan.n_micro`` microbatches (each rank's
    own rows split in order) in bfloat16 for int8 moments and float32
    otherwise, the mean taken, then one AdamW update in place.  The
    loss is a replicated DTensor."""
    set_mesh_for_alignment(mesh)
    cfg = api.cfg
    opt = make_optimizer_for(cfg)
    n_micro = plan.n_micro
    accum_dtype = torch.bfloat16 if cfg.moment_dtype == "int8" \
        else torch.float32

    def grads_of(params, mb):
        names = paths(params)
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss = api.loss_fn(unflatten(params, live), mb, mesh)
            grads = torch.autograd.grad(loss, live)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if sh.is_dtensor(g) and tuple(g.placements)
                 != tuple(p.placements) else g
                 for g, p in zip(grads, live)]
        return loss.detach(), dict(zip(names, grads))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   micro_limit=None):
        """``micro_limit`` (the dry-run's 1) runs only the first
        microbatches of the accumulation loop: its body once, as XLA's
        cost analysis counts a loop body once."""
        with sh.implicit_replication():
            if n_micro == 1:
                loss, grads = grads_of(state.params, batch)
            else:
                micro = {k: _local_microbatches(v, n_micro)
                         for k, v in batch.items()}
                gsum = {n: torch.zeros_like(p, dtype=accum_dtype)
                        for n, p in zip(paths(state.params),
                                        leaves(state.params))}
                lsum = None
                for i in range(n_micro if micro_limit is None
                               else min(micro_limit, n_micro)):
                    loss_i, g = grads_of(state.params,
                                         {k: v[i] for k, v in micro.items()})
                    gsum = {n: gsum[n] + g[n].to(accum_dtype) for n in gsum}
                    lsum = loss_i.to(torch.float32) if lsum is None \
                        else lsum + loss_i.to(torch.float32)
                grads = {n: g / n_micro for n, g in gsum.items()}
                loss = lsum / n_micro
            flat = dict(zip(paths(state.params), leaves(state.params)))
            layouts = _layouts(state.opt_state)
            _, new_opt = opt.update(grads, state.opt_state, flat,
                                    state.step)
            new_opt = _relayout(new_opt, layouts)
        return TrainState(state.params, new_opt, state.step + 1), loss

    state_shapes = abstract_train_state(api)
    state_ps = train_state_pspecs(api, mesh, state_shapes)
    bshapes = api.batch_shapes(plan.global_batch, plan.seq)
    bps = batch_pspecs(mesh, bshapes)
    return train_step, state_shapes, state_ps, bshapes, bps


# ---------------------------------------------------------------------------
# LM prefill / decode steps
# ---------------------------------------------------------------------------
def build_prefill_step(api: ModelAPI, mesh, plan: CellPlan):
    """Returns (step, params_shapes, params_pspecs, batch_shapes,
    batch_pspecs); ``step(params, batch) -> (last logits, cache)``."""
    set_mesh_for_alignment(mesh)

    def prefill_step(params, batch):
        with torch.no_grad():
            return api.prefill(params, batch, mesh)

    params_shapes = param_shapes(api)
    pp = align_pspecs(params_shapes, api.param_pspecs(mesh))
    bshapes = api.batch_shapes(plan.global_batch, plan.seq)
    bshapes.pop("targets", None)
    bps = batch_pspecs(mesh, bshapes)
    return prefill_step, params_shapes, pp, bshapes, bps


def build_decode_step(api: ModelAPI, mesh, plan: CellPlan):
    """Returns (step, (params_shapes, cache_shapes, len_shape,
    batch_shapes), (params_pspecs, cache_pspecs, P(), batch_pspecs));
    ``step(params, cache, cache_len, batch) -> (logits, cache)`` writes
    the cache in place."""
    set_mesh_for_alignment(mesh)

    def decode_step(params, cache, cache_len, batch):
        with torch.no_grad():
            return api.decode_step(params, batch, cache, cache_len, mesh)

    params_shapes = param_shapes(api)
    pp = align_pspecs(params_shapes, api.param_pspecs(mesh))
    cache_shapes = api.init_cache(plan.global_batch, plan.seq,
                                  device="meta")
    cache_spec_tree = api.cache_pspecs(mesh) if api.cache_pspecs else None
    cps = align_pspecs(cache_shapes, cache_spec_tree)
    bshapes = api.decode_shapes(plan.global_batch)
    bps = batch_pspecs(mesh, bshapes)
    len_shape = BatchShape((), torch.int32)
    return decode_step, (params_shapes, cache_shapes, len_shape, bshapes), \
        (pp, cps, P(), bps)


# ---------------------------------------------------------------------------
# the paper's linear model (rcv1_bbit) distributed train step
# ---------------------------------------------------------------------------
def _sharded_table_logits(mesh, lcfg: BBitLinearConfig):
    """logits (n, n_out) of codes (n, k) against a (k, 2^b, n_out) table
    whose value dim is sharded over 'model': each rank gathers the codes
    that fall in its slice (others count zero) and the partial logits
    meet in one all-reduce over 'model'; then the bias.  A gather on
    local shards, as the reference's ``use_kernel="never"`` path is an
    XLA gather: no B7/B8 launch."""
    dp = sh.data_axes(mesh)
    v = 1 << lcfg.b

    def forward(params, codes):
        table = params["table"]
        vspec = _drop_indivisible((v,), ("model",))[0] \
            if "model" in sh.axis_names(mesh) else None
        bspec = _drop_indivisible((codes.shape[0],), (dp,))[0] if dp \
            else None
        n_model = sh.mp_size(mesh) if vspec else 1

        def local(tab, c):
            v_l = tab.shape[1]
            lo = sh.axis_index(mesh, "model") * v_l if vspec else 0
            rel = c.to(torch.int64) - lo
            ok = (rel >= 0) & (rel < v_l)
            j = torch.arange(tab.shape[0], device=tab.device)[None, :]
            g = tab[j, torch.where(ok, rel, torch.zeros_like(rel))]
            g = g.to(torch.float32) * ok[..., None].to(torch.float32)
            return g.sum(dim=1)

        part = sh.local_apply(
            local, mesh, (P(None, vspec, None), P(bspec, None)),
            P(bspec, None), table, codes,
            out_partial=("model",) if n_model > 1 else (),
            grad_partial=tuple(dp) if bspec else ())
        out = sh.constrain(part, mesh, bspec, None)
        return out + params["bias"].to(torch.float32)

    return forward


def build_linear_train_step(paper: PaperConfig, mesh):
    """DP over examples, TP over the hashed table; logits all-reduced.
    Returns (step, state_shapes, state_pspecs, (codes_shape,
    labels_shape)); ``step(state, codes, labels) -> (state, loss)``
    updates the state in place."""
    set_mesh_for_alignment(mesh)
    lcfg = BBitLinearConfig(k=paper.k, b=paper.b,
                            n_classes=paper.n_classes,
                            use_kernel="never")
    opt = adamw(1e-2, AdamWConfig())
    loss_fn = mean_loss_fn(_sharded_table_logits(mesh, lcfg), paper.loss,
                           l2=1e-7)

    def train_step(state: TrainState, codes, labels):
        with sh.implicit_replication():
            names = list(state.params)
            live = {n: state.params[n].detach().requires_grad_(True)
                    for n in names}
            with torch.enable_grad():
                loss = loss_fn(live, codes, labels)
                gl = torch.autograd.grad(loss, [live[n] for n in names])
            grads = {n: g.redistribute(state.params[n].device_mesh,
                                       state.params[n].placements)
                     if sh.is_dtensor(g) and tuple(g.placements) != tuple(
                         state.params[n].placements) else g
                     for n, g in zip(names, gl)}
            layouts = _layouts(state.opt_state)
            _, new_opt = opt.update(grads, state.opt_state, state.params,
                                    state.step)
            new_opt = _relayout(new_opt, layouts)
        return TrainState(state.params, new_opt, state.step + 1), \
            loss.detach()

    shape = (lcfg.k, 1 << lcfg.b, lcfg.n_out)
    params = {"table": torch.empty(shape, device="meta"),
              "bias": torch.empty((lcfg.n_out,), device="meta")}
    state_shapes = init_state(params, opt)
    param_ps = {"table": P(None, "model", None), "bias": P(None)}
    state_ps = TrainState(
        params=align_pspecs(state_shapes.params, param_ps),
        opt_state=align_pspecs(state_shapes.opt_state,
                               {"m": param_ps, "v": param_ps}),
        step=P())
    codes_shape = BatchShape((paper.global_batch, paper.k), torch.int32)
    labels_shape = BatchShape((paper.global_batch,), torch.int32)
    return train_step, state_shapes, state_ps, (codes_shape, labels_shape)
