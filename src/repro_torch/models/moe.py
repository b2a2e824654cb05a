"""Mixture-of-Experts layer: token-choice top-k (counterpart of
``repro/models/moe.py``), its one-device path.

Without a mesh the reference runs a dense fallback: every expert on
every token, combined with the (T, E) gate matrix.  The port has that
path only.  The reference's expert-parallel dispatch over a mesh
(``_pack_by_expert``'s capacity packing, ``_weight_stationary_ffn`` and
the ``shard_map`` branch of ``moe_ffn``) waits for ROADMAP A6c.

Expert storage is padded to a multiple of ``max(moe_pad_to, 16)`` (the
model axis of the reference's production mesh); the router keeps exactly
``moe_experts`` outputs, so padded slots are never routed to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

EXPERT_PAD_TO = 16   # the model-axis size of the reference's mesh


def padded_experts(cfg: ArchConfig) -> int:
    e = cfg.moe_experts
    pad = max(getattr(cfg, "moe_pad_to", EXPERT_PAD_TO), EXPERT_PAD_TO)
    return ((e + pad - 1) // pad) * pad


def init_moe_params(cfg: ArchConfig, init, dtype, lead: tuple = ()) -> dict:
    e_store = padded_experts(cfg)
    d, f = cfg.d_model, cfg.moe_d_ff
    scale_in, scale_out = d ** -0.5, f ** -0.5
    n = init.normal
    p = {
        "router": n(lead + (d, cfg.moe_experts), scale_in, torch.float32),
        "w_gate": n(lead + (e_store, d, f), scale_in, dtype),
        "w_up": n(lead + (e_store, d, f), scale_in, dtype),
        "w_down": n(lead + (e_store, f, d), scale_out, dtype),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {"w_gate": n(lead + (d, fs), scale_in, dtype),
                       "w_up": n(lead + (d, fs), scale_in, dtype),
                       "w_down": n(lead + (fs, d), scale_out, dtype)}
    return p


def _routing(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """x2d (T, d) → gates (T, k) float32, expert ids (T, k) int64."""
    logits = x2d.to(torch.float32) @ router            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, idx


def _dense_fallback(x2d, params, cfg: ArchConfig):
    """All experts on all tokens, combined with the gate matrix.  The
    matrix is a sum over the chosen (token, expert) pairs, so the order
    ``topk`` lists them in does not matter."""
    gates, idx = _routing(x2d, params["router"], cfg.moe_top_k)
    e = cfg.moe_experts
    dense_gates = torch.zeros((x2d.shape[0], e), dtype=torch.float32,
                              device=x2d.device).scatter_add(1, idx, gates)
    wg, wu, wd = (params["w_gate"][:e], params["w_up"][:e],
                  params["w_down"][:e])
    h = torch.einsum("td,edf->tef", x2d, wg)
    h = F.silu(h) * torch.einsum("td,edf->tef", x2d, wu)
    y = torch.einsum("tef,efd->ted", h, wd)
    return torch.einsum("ted,te->td", y.to(torch.float32),
                        dense_gates).to(x2d.dtype)


def moe_ffn(x: torch.Tensor, params: dict, cfg: ArchConfig,
            serving: bool = False) -> torch.Tensor:
    """Top-k MoE FFN, x (B, S, d), with the shared experts added."""
    del serving      # picks a mesh dispatch in the reference (A6c)
    b, s, d = x.shape
    out = _dense_fallback(x.reshape(-1, d), params, cfg).reshape(b, s, d)
    if cfg.n_shared_experts:
        sh = params["shared"]
        h = F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])
        out = out + (h @ sh["w_down"]).to(out.dtype)
    return out
