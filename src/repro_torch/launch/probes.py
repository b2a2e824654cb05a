"""Cost probes: small traced calls whose differences give per-layer /
per-group costs on the production mesh (counterpart of
``repro/launch/probes.py``).

Probe sets per family (train kind; prefill/decode alike, forward only):

  dense/moe/vlm : L∈{1,2}                 → layer, embed+head
  hybrid        : L∈{every, 2·every}      → group (attn + every·mamba)
                  L∈{1, 2} (g=0, tail)    → mamba layer (for the tail)
  ssm (xlstm)   : L∈{every, 2·every}      → group ((every−1)·mL + 1·sL)
  audio         : (enc,dec)∈{(1,1),(2,1),(1,2)} → enc layer, dec layer

Each probe is one traced call (``launch/roofline.py::trace_step``) of a
config with ``scan_layers=False`` and loop attention, on this rank's
shards on the meta device; multipliers rebuild the full stack.  The
reference needs this because XLA counts a while-loop body once; the
port's trace counts every iteration anyway, so the probes give the same
per-layer split the reference's records carry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.roofline import (Cost, optimizer_cost,
                                         slstm_extra_flops)
from repro_torch.launch.shapes import CellPlan
from repro_torch.models.api import get_model_api


def _probe_cfg(cfg: ArchConfig, seq: int = 0, **overrides) -> ArchConfig:
    # probes unroll layers AND attention blocks; ≥32k sequences use
    # 4096² blocks (the coarser causal granularity overcounts
    # attention-score FLOPs by ≤12.5%), as in the reference
    if seq >= 32768:
        overrides.setdefault("attn_q_chunk", 4096)
        overrides.setdefault("attn_kv_chunk", 4096)
    return dataclasses.replace(cfg, scan_layers=False, attn_impl="loop",
                               **overrides)


def _micro_plan(plan: CellPlan) -> CellPlan:
    """The per-microbatch shape at which train probes run."""
    return dataclasses.replace(
        plan, global_batch=plan.global_batch // plan.n_micro, n_micro=1)


def _loss_and_grad_step(api, mesh):
    """The train probe's function: loss and gradients, no optimizer
    (that part is analytic)."""
    import torch
    from repro_torch.distributed.shardings import implicit_replication
    from repro_torch.tree import leaves, unflatten

    def fn(params, batch):
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        with implicit_replication(), torch.enable_grad():
            loss = api.loss_fn(unflatten(params, live), batch, mesh)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), grads
    return fn


def _compile_probe(cfg: ArchConfig, mesh, plan: CellPlan) -> Cost:
    """One traced call of the probe config's step → its Cost."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.roofline import cost_of_trace
    api = get_model_api(cfg)
    steps_lib.set_mesh_for_alignment(mesh)
    if plan.kind != "train":
        _, trace = dryrun.trace_cell(api, mesh, plan)
        return trace.cost
    bshapes = api.batch_shapes(plan.global_batch, plan.seq)
    bps = steps_lib.batch_pspecs(mesh, bshapes)
    pshapes = steps_lib.param_shapes(api)
    pp = steps_lib.align_pspecs(pshapes, api.param_pspecs(mesh))
    params = dryrun._meta_tree(pshapes, pp, mesh)
    batch = dryrun._meta_tree(bshapes, bps, mesh)
    return cost_of_trace(_loss_and_grad_step(api, mesh), params, batch)


def _count_params(cfg: ArchConfig) -> int:
    from repro_torch.tree import leaves
    total = 0
    for leaf in leaves(get_model_api(cfg).init_params(None, device="meta")):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
    return total


def assemble_cell_cost(cfg: ArchConfig, shape: str, mesh,
                       plan: CellPlan) -> Tuple[Cost, Dict]:
    """Returns (total per-device Cost, probe detail dict)."""
    mp = _micro_plan(plan) if plan.kind == "train" else plan
    fam = cfg.family
    n_dev = mesh.size()
    detail: Dict = {"kind": plan.kind, "n_micro": plan.n_micro}

    if fam in ("dense", "moe", "vlm"):
        c1 = _compile_probe(_probe_cfg(cfg, mp.seq, n_layers=1), mesh, mp)
        c2 = _compile_probe(_probe_cfg(cfg, mp.seq, n_layers=2), mesh, mp)
        layer = (c2 - c1).clamped()
        embed = (c1 - layer).clamped()
        total = cfg.n_layers * layer + embed
        detail.update(layer=layer.to_dict(), embed_head=embed.to_dict(),
                      multipliers={"layer": cfg.n_layers})
    elif fam == "hybrid":
        every = cfg.hybrid_attn_every
        groups = cfg.n_layers // every
        tail = cfg.n_layers - groups * every
        g1 = _compile_probe(_probe_cfg(cfg, mp.seq, n_layers=every),
                            mesh, mp)
        g2 = _compile_probe(_probe_cfg(cfg, mp.seq, n_layers=2 * every),
                            mesh, mp)
        group = (g2 - g1).clamped()
        embed = (g1 - group).clamped()
        total = groups * group + embed
        detail.update(group=group.to_dict(), embed_head=embed.to_dict(),
                      multipliers={"group": groups, "tail": tail})
        if tail:
            m1 = _compile_probe(_probe_cfg(cfg, mp.seq, n_layers=1),
                                mesh, mp)
            m2 = _compile_probe(_probe_cfg(cfg, mp.seq, n_layers=2),
                                mesh, mp)
            mamba_layer = (m2 - m1).clamped()
            total = total + tail * mamba_layer
            detail["mamba_layer"] = mamba_layer.to_dict()
    elif fam == "ssm":
        every = cfg.slstm_every
        g1 = _compile_probe(_probe_cfg(cfg, mp.seq, n_layers=every),
                            mesh, mp)
        g2 = _compile_probe(_probe_cfg(cfg, mp.seq, n_layers=2 * every),
                            mesh, mp)
        group = (g2 - g1).clamped()
        embed = (g1 - group).clamped()
        groups = cfg.n_layers // every
        total = groups * group + embed
        extra = slstm_extra_flops(cfg, mp.global_batch, mp.seq, n_dev)
        if plan.kind == "train":
            extra *= 3.0       # fwd + bwd + remat recompute
        total = total + Cost(flops=extra)
        detail.update(group=group.to_dict(), embed_head=embed.to_dict(),
                      slstm_extra_flops=extra,
                      multipliers={"group": groups})
    elif fam == "audio":
        c11 = _compile_probe(
            _probe_cfg(cfg, mp.seq, n_layers=1, enc_layers=1), mesh, mp)
        c21 = _compile_probe(
            _probe_cfg(cfg, mp.seq, n_layers=1, enc_layers=2), mesh, mp)
        c12 = _compile_probe(
            _probe_cfg(cfg, mp.seq, n_layers=2, enc_layers=1), mesh, mp)
        enc_layer = (c21 - c11).clamped()
        dec_layer = (c12 - c11).clamped()
        embed = (c11 - enc_layer - dec_layer).clamped()
        total = (cfg.enc_layers * enc_layer + cfg.n_layers * dec_layer
                 + embed)
        detail.update(enc_layer=enc_layer.to_dict(),
                      dec_layer=dec_layer.to_dict(),
                      embed_head=embed.to_dict(),
                      multipliers={"enc": cfg.enc_layers,
                                   "dec": cfg.n_layers})
    else:
        raise ValueError(fam)

    if plan.kind == "train":
        total = plan.n_micro * total
        opt = optimizer_cost(_count_params(cfg), n_dev, cfg.moment_dtype)
        total = total + opt
        detail["optimizer"] = opt.to_dict()
    return total, detail
