"""Mixture-of-Experts layer: token-choice top-k with capacity (GShard)
(counterpart of ``repro/models/moe.py``).

Execution paths:

  * ``mesh=None``: the dense fallback — every expert runs on every
    token, combined with the (T, E) gate matrix (no capacity drops).
  * ``mesh`` given: expert parallelism over 'model', on local shards
    (``distributed/shardings.py::local_apply``, the reference's
    ``shard_map``).  Activations enter replicated across 'model' (they
    are only batch-sharded), so every model shard packs the full
    (E·C, d) buffer (sort-based, ``_pack_by_expert``; tokens past an
    expert's capacity are dropped), runs the expert slice it owns,
    gathers its partial per-token outputs, and one all-reduce over
    'model' at the input dtype combines them (a DTensor partial sum,
    redistributed).  The expert weights are FSDP-sharded over the data
    axes (the d dim) and all-gathered just in time (ZeRO-3).
  * ``serving`` with ``moe_serving_dispatch="weight_stationary"`` on a
    mesh with one data axis: experts 2D-sharded over (data, model),
    fully resident; tokens travel to their experts' owners with two
    all-to-alls over 'data' and the columns combine with one all-reduce
    over 'model' (``_weight_stationary_ffn``).

Expert storage is padded to a multiple of ``max(moe_pad_to, 16)`` (the
model axis of the reference's production mesh); the router keeps exactly
``moe_experts`` outputs, so padded slots are never routed to.

``held_moe_ffn`` is the layer of an ``MLAConfig`` (DeepSeek-V3's routing):
it holds ``experts_held`` experts of the ``moe_experts`` its router scores
(ids ``experts_first`` on, one card's share under expert parallelism),
routes every token over all of them, and computes only the (token, held
expert) pairs, grouped by expert, with no capacity and no drop (a decode
step runs them all, weighted, instead: ``_held_all_tokens``); the shared
expert runs on every token.  What the
experts held elsewhere add is not computed here (on one card, no
exchange stands in for them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import shardings as sh

P = sh.P
# (token, held expert) pairs computed, and tokens routed, by held_moe_ffn
# (a decode step's by transformer.mla_decode_step)
MOE_ROWS = obs.counter("lm.moe_rows")
MOE_TOKENS = obs.counter("lm.moe_tokens")

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


def moe_param_pspecs(cfg: ArchConfig, dp_axes=("data",)) -> dict:
    """Experts over 'model' (EP); the d dim over the data axes (FSDP).

    The weight_stationary serving mode 2D-shards the expert dim over
    (data…, model) instead — experts fully resident per device, tokens
    travel."""
    dshard = tuple(dp_axes) if dp_axes else None
    if cfg.moe_serving_dispatch == "weight_stationary":
        all_axes = tuple(dp_axes) + ("model",)
        p = {
            "router": P(None, None),
            "w_gate": P(all_axes, None, None),
            "w_up": P(all_axes, None, None),
            "w_down": P(all_axes, None, None),
        }
        if cfg.n_shared_experts:
            p["shared"] = {"w_gate": P(None, "model"),
                           "w_up": P(None, "model"),
                           "w_down": P("model", None)}
        return p
    p = {
        "router": P(None, None),
        "w_gate": P("model", dshard, None),
        "w_up": P("model", dshard, None),
        "w_down": P("model", None, dshard),
    }
    if cfg.n_shared_experts:
        p["shared"] = {
            "w_gate": P(None, "model"),
            "w_up": P(None, "model"),
            "w_down": P("model", None),
        }
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


def _pack_by_expert(x2d, gates, idx, n_slots: int, capacity: int):
    """Sort-based capacity packing into an (n_slots·C, d) buffer.

    Assignments (token t, choice j) are ranked within their expert in
    the order t·k + j (a stable sort by expert); those at rank ≥ C are
    dropped.  Returns (buf, slot (T, k) — n_slots·C where dropped —,
    gates with the drops zeroed)."""
    t, k = idx.shape
    dev = x2d.device
    flat_e = idx.reshape(-1).to(torch.int64)
    sort_ix = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[sort_ix]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_slots, device=dev), right=False)
    pos_in_e = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < capacity
    dropped = n_slots * capacity
    slot_sorted = torch.where(keep, sorted_e * capacity + pos_in_e,
                              torch.full_like(pos_in_e, dropped))
    slot_flat = torch.empty_like(slot_sorted)
    slot_flat[sort_ix] = slot_sorted
    slot = slot_flat.reshape(t, k)
    token_of_sorted = sort_ix // k
    buf = torch.zeros((dropped + 1, x2d.shape[1]), dtype=x2d.dtype,
                      device=dev)
    # T rows a scatter: the gathered rows never exist as one (T·k, d)
    # buffer (XLA fuses the reference's gather into its scatter)
    for lo in range(0, t * k, t):
        buf[slot_sorted[lo:lo + t]] = x2d[token_of_sorted[lo:lo + t]]
    gates = torch.where(slot == dropped, torch.zeros_like(gates), gates)
    return buf[:-1], slot, gates


def _expert_ffn(xe, w_gate, w_up, w_down):
    """xe (E_l, C', d) through each expert's SwiGLU."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, w_gate)) * \
        torch.einsum("ecd,edf->ecf", xe, w_up)
    return torch.einsum("ecf,efd->ecd", h, w_down)


def _capacity(cfg: ArchConfig, t_local: int) -> int:
    return int(cfg.moe_capacity * cfg.moe_top_k * t_local
               // cfg.moe_experts) + 1


def _combine(per_assign, gates, dtype):
    """Σ_k per_assign (T,k,d) · gates (T,k): operands at the input
    dtype, a batched matmul that accumulates in float32 and rounds once
    (the reference's ``preferred_element_type``); the (T,k,d) buffer
    stays at the input dtype."""
    return torch.bmm(per_assign.transpose(1, 2),
                     gates.to(dtype)[..., None])[..., 0]


def _weight_stationary_ffn(x, params, cfg: ArchConfig, mesh):
    """Serving dispatch: experts 2D-sharded over (data, model), fully
    resident; tokens all_to_all over 'data' within each model column;
    one all-reduce over 'model' combines the columns."""
    import torch.distributed._functional_collectives as funcol
    b, s, d = x.shape
    dp_axes = sh.data_axes(mesh)
    mdl = sh.axis_size(mesh, "model")
    dpn = sh.dp_size(mesh)
    n_dev = dpn * mdl
    e_store = padded_experts(cfg)
    if e_store % n_dev:
        raise ValueError(f"weight_stationary needs the {e_store} stored "
                         f"experts to divide over {n_dev} devices")
    e_per_dev = e_store // n_dev
    all_axes = dp_axes + ("model",)
    dgroup = sh.group_of(mesh, dp_axes[0])

    def a2a(t):
        flat = t.reshape(t.shape[0], -1).contiguous()
        out = funcol.all_to_all_single(flat, None, None, dgroup)
        return funcol.wait_tensor(out).reshape(t.shape)

    def ws(x_l, router, w_gate, w_up, w_down):
        bl, sl, _ = x_l.shape
        t_l = bl * sl
        m_idx = sh.axis_index(mesh, "model")
        x2d = x_l.reshape(t_l, d)
        gates, idx = _routing(x2d, router, cfg.moe_top_k)
        cap = _capacity(cfg, t_l)
        buf, slot, gates = _pack_by_expert(x2d, gates, idx, e_store, cap)
        buf = buf.reshape(e_store, cap, d)
        # experts of model column m: e = (q·mdl + m)·e_per_dev + r
        dev = x_l.device
        col_experts = ((torch.arange(dpn, device=dev)[:, None] * mdl
                        + m_idx) * e_per_dev
                       + torch.arange(e_per_dev, device=dev)[None, :]
                       ).reshape(-1)
        sub = buf[col_experts].reshape(dpn, e_per_dev, cap, d)
        sub = a2a(sub)                       # tokens → owners
        xe = sub.transpose(0, 1).reshape(e_per_dev, dpn * cap, d)
        ye = _expert_ffn(xe, w_gate, w_up, w_down)
        ye = ye.reshape(e_per_dev, dpn, cap, d).transpose(0, 1)
        ye = a2a(ye)                         # results → sources
        ye = ye.reshape(dpn * e_per_dev, cap, d)
        ye_col = torch.zeros((e_store * cap + 1, d), dtype=x_l.dtype,
                             device=dev)
        rowsel = (col_experts[:, None] * cap
                  + torch.arange(cap, device=dev)[None, :]).reshape(-1)
        ye_col[rowsel] = ye.reshape(-1, d).to(x_l.dtype)
        per_assign = ye_col[slot.reshape(-1)].reshape(
            t_l, cfg.moe_top_k, d)
        return _combine(per_assign, gates, x_l.dtype).reshape(bl, sl, d)

    w = P(all_axes, None, None)
    y = sh.local_apply(ws, mesh, (P(dp_axes, None, None), P(None, None),
                                  w, w, w),
                       P(dp_axes, None, None), x, params["router"],
                       params["w_gate"], params["w_up"], params["w_down"],
                       out_partial=("model",))
    return sh.constrain(y, mesh, dp_axes, None, None)


def _expert_parallel_ffn(x, params, cfg: ArchConfig, mesh):
    """The 'model'-axis expert-parallel dispatch (module docstring)."""
    b, s, d = x.shape
    dp_axes = sh.data_axes(mesh)
    ep = sh.axis_size(mesh, "model")
    e_store = padded_experts(cfg)
    if e_store % ep:
        raise ValueError(f"expert parallelism needs the {e_store} stored "
                         f"experts to divide over model={ep}")
    e_local = e_store // ep
    bspec = dp_axes if dp_axes and b % sh.dp_size(mesh) == 0 else None

    def ep_body(x_l, router, w_gate, w_up, w_down):
        bl, sl, _ = x_l.shape
        t_l = bl * sl
        m_idx = sh.axis_index(mesh, "model")
        x2d = x_l.reshape(t_l, d)
        gates, idx = _routing(x2d, router, cfg.moe_top_k)
        cap = _capacity(cfg, t_l)
        buf, slot, gates = _pack_by_expert(x2d, gates, idx, e_store, cap)
        lo = m_idx * (e_local * cap)
        xe = buf[lo:lo + e_local * cap].reshape(e_local, cap, d)
        ye = _expert_ffn(xe, w_gate, w_up, w_down)
        ye_flat = ye.reshape(e_local * cap, d).to(x_l.dtype)
        local_slot = slot - lo
        in_range = (local_slot >= 0) & (local_slot < e_local * cap)
        safe = torch.where(in_range, local_slot,
                           torch.zeros_like(local_slot))
        per_assign = ye_flat[safe.reshape(-1)].reshape(
            t_l, cfg.moe_top_k, d)
        # another shard's slots: a zero gate (the expert outputs are
        # finite), not a masked (T, k, d) copy
        gates = torch.where(in_range, gates, torch.zeros_like(gates))
        return _combine(per_assign, gates, x_l.dtype).reshape(bl, sl, d)

    # the expert weights arrive with their d dim whole: their FSDP
    # shards are all-gathered here, just in time
    w = P("model", None, None)
    y = sh.local_apply(ep_body, mesh, (P(bspec, None, None), P(None, None),
                                       w, w, w),
                       P(bspec, None, None), x, params["router"],
                       params["w_gate"], params["w_up"], params["w_down"],
                       out_partial=("model",),
                       grad_partial=("model",) + (dp_axes if bspec else ()))
    # the partial sums over 'model' meet in one all-reduce at x's dtype
    return sh.constrain(y, mesh, bspec, None, None)


def moe_ffn(x: torch.Tensor, params: dict, cfg: ArchConfig, mesh=None,
            serving: bool = False) -> torch.Tensor:
    """Top-k MoE FFN, x (B, S, d), with the shared experts added; expert
    parallelism over 'model' when a mesh is given."""
    b, s, d = x.shape
    if mesh is None or "model" not in sh.axis_names(mesh):
        out = _dense_fallback(x.reshape(-1, d), params, cfg).reshape(
            b, s, d)
    elif (serving and cfg.moe_serving_dispatch == "weight_stationary"
          and len(sh.data_axes(mesh)) == 1):
        out = _weight_stationary_ffn(x, params, cfg, mesh)
    else:
        out = _expert_parallel_ffn(x, params, cfg, mesh)
    if cfg.n_shared_experts:
        sh_p = params["shared"]
        h = F.silu(x @ sh_p["w_gate"]) * (x @ sh_p["w_up"])
        out = out + (h @ sh_p["w_down"]).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# the held-expert layer of an MLAConfig (DeepSeek-V3 routing)
# ---------------------------------------------------------------------------
def init_held_moe_params(cfg, init, dtype, lead: tuple = ()) -> dict:
    """The router over all ``moe_experts`` (float32, with its
    score-correction bias), the ``experts_held`` experts and the shared
    expert, stacked on ``lead``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.experts_held
    fs = cfg.moe_d_ff * cfg.n_shared_experts
    n = init.normal
    return {
        "router": n(lead + (d, cfg.moe_experts), d ** -0.5, torch.float32),
        "router_bias": n(lead + (cfg.moe_experts,), 0.01, torch.float32),
        "w_gate": n(lead + (e, d, f), d ** -0.5, dtype),
        "w_up": n(lead + (e, d, f), d ** -0.5, dtype),
        "w_down": n(lead + (e, f, d), f ** -0.5, dtype),
        "shared": {"w_gate": n(lead + (d, fs), d ** -0.5, dtype),
                   "w_up": n(lead + (d, fs), d ** -0.5, dtype),
                   "w_down": n(lead + (fs, d), fs ** -0.5, dtype)},
    }


def route(x2d: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float):
    """x2d (T, d) → weights (T, k) float32, expert ids (T, k) int64:
    sigmoid scores over every expert, the top k of scores + ``bias`` (the
    bias picks, it does not weigh), their scores normalised to sum 1 and
    times ``scale``."""
    scores = torch.sigmoid(x2d.to(torch.float32) @ router)
    idx = torch.topk(scores + bias, top_k, dim=-1).indices
    w = torch.gather(scores, 1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scale, idx


def _shared_expert(x2d: torch.Tensor, params: dict) -> torch.Tensor:
    sh_p = params["shared"]
    h = F.silu(x2d @ sh_p["w_gate"]) * (x2d @ sh_p["w_up"])
    return (h @ sh_p["w_down"]).to(torch.float32)


def _held_all_tokens(x2d, w, idx, params, cfg) -> torch.Tensor:
    """A decode step: every held expert runs on all its tokens in one
    batched product, weighted by its routing weight (zero where the token
    did not choose it), so nothing is read back to the host and the step
    can be one CUDA graph, at any batch.  It reads every held expert's
    weights where grouping reads only the chosen ones' (at Kimi-K2's
    sizes 1.06 GB a layer, about a third of a millisecond on an H100,
    against a read-back and ~60 host launches a layer).  Its t × held
    pairs are counted by the decode step, which a replay skips."""
    t, d = x2d.shape
    n_held = cfg.experts_held
    local = idx - cfg.experts_first
    held = (local >= 0) & (local < n_held)
    gate = torch.zeros((t, n_held), dtype=torch.float32,
                       device=x2d.device).scatter_add_(
        1, local.clamp(0, n_held - 1), torch.where(held, w, 0.0))
    xe = x2d.expand(n_held, t, d)
    h = F.silu(torch.bmm(xe, params["w_gate"])) * \
        torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"])
    out = _shared_expert(x2d, params) + torch.einsum(
        "etd,te->td", ye.to(torch.float32), gate)
    return out.to(x2d.dtype)


def held_moe_ffn(x: torch.Tensor, params: dict, cfg,
                 decode: bool = False) -> torch.Tensor:
    """x (B, S, d) → this card's part of the MoE layer: the routed pairs
    on the held experts, weighted, plus the shared expert.  The pairs are
    sorted by expert and each held expert runs once on its rows; their
    weighted outputs are summed in float32 one choice slot at a time (a
    token has one pair a slot, so the sums are in a fixed order).  A
    ``decode`` step reads nothing back: ``_held_all_tokens``."""
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    t, k = x2d.shape[0], cfg.moe_top_k
    n_held = cfg.experts_held
    with obs.span("lm.moe"):
        w, idx = route(x2d, params["router"], params["router_bias"], k,
                       cfg.moe_routed_scale)
        if decode:
            return _held_all_tokens(x2d, w, idx, params, cfg).reshape(b, s, d)
        # pairs (t, j) as t·k + j; those on an expert held elsewhere sort
        # last, under the key n_held, and one read brings the counts back
        local = (idx - cfg.experts_first).reshape(-1)
        held = (local >= 0) & (local < n_held)
        key = torch.where(held, local, n_held)
        counts = torch.cat([torch.bincount(key, minlength=n_held + 1)[:-1],
                            held.view(t, k).sum(0)]).tolist()
        per_expert, per_slot = counts[:n_held], counts[n_held:]
        pair = torch.argsort(key, stable=True)[:sum(per_expert)]
        tok, slot = pair // k, pair % k
        xs = x2d[tok]
        ys = torch.empty_like(xs)
        lo = 0
        for e, rows in enumerate(per_expert):
            if rows:
                h = F.silu(xs[lo:lo + rows] @ params["w_gate"][e]) * \
                    (xs[lo:lo + rows] @ params["w_up"][e])
                ys[lo:lo + rows] = h @ params["w_down"][e]
            lo += rows
        contrib = ys.to(torch.float32) * w.reshape(-1)[pair][:, None]
        out = _shared_expert(x2d, params)
        by_slot = torch.argsort(slot, stable=True)
        lo = 0
        for rows in per_slot:
            if rows:
                sel = by_slot[lo:lo + rows]
                out.index_add_(0, tok[sel], contrib[sel])
            lo += rows
        MOE_ROWS.add(len(tok))
        MOE_TOKENS.add(t)
        return out.to(x.dtype).reshape(b, s, d)
