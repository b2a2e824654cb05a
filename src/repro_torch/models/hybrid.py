"""The hybrid (zamba2) and xLSTM (xlstm-350m) model stacks (counterpart
of ``repro/models/hybrid.py``).

zamba2: ``n_layers`` Mamba2 blocks; before every group of
``hybrid_attn_every`` blocks a *shared* attention(+MLP) block is
applied, alternating between ``hybrid_shared_attn_blocks`` weight sets
(Zamba weight sharing).  81 layers at every=6: 13 groups of
[shared-attn, 6×mamba] and 3 tail mamba blocks.  As in the reference,
the shared block reads the plain residual stream (the original also
concatenates the initial embedding).

xlstm: groups of [(slstm_every−1)×mLSTM, 1×sLSTM].

Both keep models/transformer.py's train/prefill/decode contract.  Their
caches are the reference's trees: the Mamba2 states are (h, conv)
tuples stacked per group, the xLSTM ones (C, n, m) and (c, n, h, m).

On a mesh the shared attention blocks, embeddings and head run as in
``models/transformer.py``.  The Mamba2, mLSTM and sLSTM blocks run
data-parallel on local shards (``_local_block``): the batch over the
data axes, their weights (TP/FSDP-sharded at rest by the pspecs below)
gathered whole just in time, the same work on every model rank.  Their
heads are not split over 'model'.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import shardings as sh
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import ParamInit, rmsnorm
from repro_torch.models.transformer import (_dtype, attn_apply,
                                            attn_pspecs, build_positions,
                                            checkpointed, dp_axes_of,
                                            embed_tokens, ffn_apply,
                                            init_attn_params,
                                            init_embed_params, lm_head,
                                            maybe_shard)

P = sh.P
from repro_torch.tree import tree_map, tree_stack


def _loop(cfg, body, x, xs, length):
    """``body(x, xs[i])`` for i < length → (x, the outputs stacked, or
    None): the reference's ``lax.scan`` or unrolled loop, which compute
    the same.  ``xs`` is a tree stacked on its leading axis (a ``range``
    leaf gives the index)."""
    del cfg
    ys = []
    for i in range(length):
        x, y = body(x, tree_map(lambda a: a[i], xs) if xs is not None
                    else None)
        ys.append(y)
    return x, tree_stack(ys, torch.stack)


def _remat(cfg, fn):
    """The reference wraps these bodies in a plain ``jax.checkpoint``."""
    return checkpointed(fn) if cfg.remat else fn


# ---------------------------------------------------------------------------
# zamba2-style hybrid
# ---------------------------------------------------------------------------
def _hybrid_layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    per = cfg.hybrid_attn_every
    groups = cfg.n_layers // per
    return groups, per, cfg.n_layers - groups * per


def _init_mamba_layers(cfg, init, dtype, lead):
    p = ssm_lib.init_mamba2_params(cfg, init, dtype, lead)
    p["ln"] = init.full(lead + (cfg.d_model,), 1.0, dtype)
    return p


def init_hybrid_params(cfg: ArchConfig, init: ParamInit) -> dict:
    dtype = _dtype(cfg)
    groups, per, tail = _hybrid_layout(cfg)
    params = init_embed_params(cfg, init, dtype)
    # groups == 0 gives (0, per, ...) leaves, as the reference's zeros
    params["mamba"] = _init_mamba_layers(cfg, init, dtype, (groups, per))
    if tail:
        params["mamba_tail"] = _init_mamba_layers(cfg, init, dtype, (tail,))
    params["attn"] = init_attn_params(
        cfg, init, dtype, lead=(cfg.hybrid_shared_attn_blocks,))
    return params


def _local_block(core, mesh, params: dict, h, state):
    """``core(params, h, state) -> (y, new state tuple)`` with the
    batch over the data axes and the weights whole on every rank (see
    the module docstring); plain off a mesh."""
    if mesh is None:
        return core(params, h, state)
    bspec = sh.divisible_spec((h.shape[0],), mesh, (dp_axes_of(mesh),))[0]
    names = sorted(params)
    st = list(state) if state is not None else []
    n = len(names)

    def body(h_l, *rest):
        y, new = core(dict(zip(names, rest[:n])), h_l,
                      tuple(rest[n:]) if st else None)
        return (y,) + tuple(new)

    specs = ((P(bspec),) + tuple(P() for _ in names)
             + tuple(P(bspec) for _ in st))
    out = sh.local_apply(body, mesh, specs, (P(bspec),) * 8, h,
                         *(params[k] for k in names), *st,
                         grad_partial=dp_axes_of(mesh) if bspec else ())
    return out[0], tuple(out[1:])


def _mamba_block(lp, x, cfg, mesh=None, state=None, chunk=128):
    h = rmsnorm(x, lp["ln"], cfg.norm_eps)
    h = maybe_shard(h, mesh, dp_axes_of(mesh), None, None)

    def core(p, h, st):
        return ssm_lib.mamba2_forward(
            p, h, cfg, h0=None if st is None else st[0],
            conv0=None if st is None else st[1], chunk=chunk)

    y, new_state = _local_block(
        core, mesh, {k: v for k, v in lp.items() if k != "ln"}, h, state)
    return x + y, tuple(new_state)


def _select_attn(params, g_idx, n_shared):
    return tree_map(lambda p: p[g_idx % n_shared], params["attn"])


def _mamba_stack(cfg, x, layer_params, length, states=None, chunk=128,
                 remat=True, keep=True, mesh=None):
    """Runs ``length`` stacked Mamba2 blocks → (x, their new states
    stacked, or None without ``keep``)."""
    if states is None:
        def body(xi, lp):
            xi, st = _mamba_block(lp, xi, cfg, mesh, chunk=chunk)
            return xi, st if keep else None
        xs = layer_params
    else:
        def body(xi, inp):
            lp, st = inp
            return _mamba_block(lp, xi, cfg, mesh, state=st, chunk=chunk)
        xs = (layer_params, states)
    return _loop(cfg, _remat(cfg, body) if remat else body, x, xs, length)


def hybrid_forward_train(params, tokens, cfg: ArchConfig, mesh=None):
    x, _ = _hybrid_run(params, tokens, cfg, "train", mesh)
    return lm_head(params, x, cfg, mesh)


def _hybrid_run(params, tokens, cfg: ArchConfig, mode: str, mesh=None):
    """train | prefill over the whole stack → (x, cache or None)."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg, mesh)
    positions = build_positions(cfg, b, s, device=tokens.device)
    groups, per, tail = _hybrid_layout(cfg)
    nsh = cfg.hybrid_shared_attn_blocks

    def group_body(xc, inp):
        g_idx, g_params = inp
        ap = _select_attn(params, g_idx, nsh)
        xc, kv = attn_apply(ap, xc, cfg=cfg, mesh=mesh,
                            positions=positions, mode=mode)
        xc = ffn_apply(ap, xc, cfg, mesh)
        keep = mode == "prefill"
        xc, states = _mamba_stack(cfg, xc, g_params, per, keep=keep,
                                  mesh=mesh)
        return xc, (states, kv) if keep else None

    cache = None
    if groups:
        x, ys = _loop(cfg, _remat(cfg, group_body), x,
                      (range(groups), params["mamba"]), groups)
        if mode == "prefill":
            cache = {"mamba": ys[0], "attn": ys[1]}
    elif mode == "prefill":          # tail-only stacks
        empty = init_hybrid_cache(cfg, b, s, device=tokens.device)
        cache = {"mamba": empty["mamba"], "attn": empty["attn"]}
    if tail:
        x, tail_states = _mamba_stack(cfg, x, params["mamba_tail"], tail,
                                      keep=mode == "prefill", mesh=mesh)
        if mode == "prefill":
            cache["mamba_tail"] = tail_states
    return x, cache


def init_hybrid_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device=None):
    dtype = _dtype(cfg)
    groups, per, tail = _hybrid_layout(cfg)
    d_in, nh, n = ssm_lib.ssm_dims(cfg)
    cw = cfg.ssm_conv_width

    def mk_ssm(*lead):
        return (torch.zeros(lead + (batch, nh, n, cfg.ssm_head_dim),
                            dtype=torch.float32, device=device),
                torch.zeros(lead + (batch, cw - 1, d_in + 2 * n),
                            dtype=dtype, device=device))

    kv_shape = (groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "mamba": mk_ssm(groups, per),
        "attn": {"k": torch.zeros(kv_shape, dtype=dtype, device=device),
                 "v": torch.zeros(kv_shape, dtype=dtype, device=device)},
    }
    if tail:
        cache["mamba_tail"] = mk_ssm(tail)
    return cache


def hybrid_decode_step(params, token, cache, cache_len, cfg: ArchConfig,
                       mesh=None):
    """One token: the attention caches are written in place, the Mamba2
    states replaced → (logits (B,V), the new cache)."""
    b = token.shape[0]
    x = embed_tokens(params, token, cfg, mesh)
    positions = build_positions(cfg, b, 1, offset=cache_len,
                                device=token.device)
    groups, per, tail = _hybrid_layout(cfg)
    nsh = cfg.hybrid_shared_attn_blocks

    def group_body(xc, inp):
        g_idx, g_params, g_state, g_kv = inp
        ap = _select_attn(params, g_idx, nsh)
        xc, new_kv = attn_apply(ap, xc, cfg=cfg, mesh=mesh,
                                positions=positions, mode="decode",
                                cache=g_kv, cache_len=cache_len)
        xc = ffn_apply(ap, xc, cfg, mesh)
        xc, new_states = _mamba_stack(cfg, xc, g_params, per, g_state,
                                      chunk=1, remat=False, mesh=mesh)
        return xc, new_states

    new_cache = {"mamba": cache["mamba"], "attn": cache["attn"]}
    if groups:
        x, new_mamba = _loop(
            cfg, group_body, x,
            (range(groups), params["mamba"], cache["mamba"],
             cache["attn"]), groups)
        new_cache["mamba"] = new_mamba
    if tail:
        x, new_cache["mamba_tail"] = _mamba_stack(
            cfg, x, params["mamba_tail"], tail, cache["mamba_tail"],
            chunk=1, remat=False, mesh=mesh)
    return lm_head(params, x, cfg, mesh)[:, 0], new_cache


def hybrid_prefill(params, tokens, cfg: ArchConfig, mesh=None):
    """→ (last logits (B,V), cache at len = tokens.shape[1])."""
    x, cache = _hybrid_run(params, tokens, cfg, "prefill", mesh)
    return lm_head(params, x[:, -1:], cfg, mesh)[:, 0], cache


def hybrid_param_pspecs(cfg: ArchConfig, mesh) -> dict:
    dp = dp_axes_of(mesh) or None
    mamba_spec = {
        "ln": P(None, None, None),
        "in_proj": P(None, None, dp, "model"),
        "conv_w": P(None, None, None, "model"),
        "conv_b": P(None, None, "model"),
        "a_log": P(None, None, None),
        "dt_bias": P(None, None, None),
        "d_skip": P(None, None, None),
        "norm_scale": P(None, None, "model"),
        "out_proj": P(None, None, "model", dp),
    }
    out = {
        "embed": ({"hash_tables": P(None, None, "model")}
                  if cfg.embedding == "bbit_hash"
                  else {"table": P(None, "model")}),
        "final_norm": P(None),
        "lm_head": P(dp, "model"),
        "mamba": mamba_spec,
        "attn": attn_pspecs(cfg, dp, stacked=True),
    }
    groups, per, tail = _hybrid_layout(cfg)
    if tail:
        out["mamba_tail"] = sh.spec_map(lambda s: P(*s[1:]), mamba_spec)
    return out


# ---------------------------------------------------------------------------
# xLSTM stack
# ---------------------------------------------------------------------------
def _xlstm_layout(cfg: ArchConfig) -> Tuple[int, int]:
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def init_xlstm_stack_params(cfg: ArchConfig, init: ParamInit) -> dict:
    dtype = _dtype(cfg)
    groups, per = _xlstm_layout(cfg)
    params = init_embed_params(cfg, init, dtype)
    params["mlstm"] = xlstm_lib.init_mlstm_params(cfg, init, dtype,
                                                  (groups, per))
    params["mlstm"]["ln"] = init.full((groups, per, cfg.d_model), 1.0,
                                      dtype)
    params["slstm"] = xlstm_lib.init_slstm_params(cfg, init, dtype,
                                                  (groups,))
    params["slstm"]["ln"] = init.full((groups, cfg.d_model), 1.0, dtype)
    return params


def _mlstm_block(lp, x, cfg, mesh=None, state=None, chunk=128):
    h = rmsnorm(x, lp["ln"], cfg.norm_eps)
    y, st = _local_block(
        lambda p, h, s: xlstm_lib.mlstm_forward(p, h, cfg, state=s,
                                                chunk=chunk),
        mesh, {k: v for k, v in lp.items() if k != "ln"}, h, state)
    return x + y, tuple(st)


def _slstm_block(lp, x, cfg, mesh=None, state=None):
    h = rmsnorm(x, lp["ln"], cfg.norm_eps)
    y, st = _local_block(
        lambda p, h, s: xlstm_lib.slstm_forward(p, h, cfg, state=s),
        mesh, {k: v for k, v in lp.items() if k != "ln"}, h, state)
    return x + y, tuple(st)


def xlstm_forward_train(params, tokens, cfg: ArchConfig, mesh=None):
    x = embed_tokens(params, tokens, cfg, mesh)
    groups, per = _xlstm_layout(cfg)

    def group_body(xc, inp):
        g_m, g_s = inp

        def m_body(xi, lp):
            xi, _ = _mlstm_block(lp, xi, cfg, mesh)
            return xi, None

        xc, _ = _loop(cfg, _remat(cfg, m_body), xc, g_m, per)
        xc, _ = _slstm_block(g_s, xc, cfg, mesh)
        return xc, None

    x, _ = _loop(cfg, _remat(cfg, group_body), x,
                 (params["mlstm"], params["slstm"]), groups)
    return lm_head(params, x, cfg, mesh)


def init_xlstm_cache(cfg: ArchConfig, batch: int, max_len: int,
                     device=None):
    del max_len                      # recurrent: O(1) state
    groups, per = _xlstm_layout(cfg)
    _, p = xlstm_lib.xlstm_dims(cfg)
    h = cfg.n_heads
    ps = cfg.d_model // h

    def full(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "mlstm": (full(0.0, groups, per, batch, h, p, p),
                  full(0.0, groups, per, batch, h, p),
                  full(-1e30, groups, per, batch, h)),
        "slstm": (full(0.0, groups, batch, h, ps),
                  full(1.0, groups, batch, h, ps),
                  full(0.0, groups, batch, h, ps),
                  full(-1e30, groups, batch, h, ps)),
    }


def xlstm_apply_with_state(params, tokens, cache, cfg: ArchConfig,
                           mesh=None, chunk=128):
    """Shared prefill/decode: runs tokens through, carrying states."""
    x = embed_tokens(params, tokens, cfg, mesh)
    groups, per = _xlstm_layout(cfg)

    def group_body(xc, inp):
        g_m, g_s, st_m, st_s = inp

        def m_body(xi, inp2):
            lp, st = inp2
            return _mlstm_block(lp, xi, cfg, mesh, state=st, chunk=chunk)

        xc, new_m = _loop(cfg, m_body, xc, (g_m, st_m), per)
        xc, new_s = _slstm_block(g_s, xc, cfg, mesh, state=st_s)
        return xc, (new_m, new_s)

    x, (new_m, new_s) = _loop(
        cfg, group_body, x,
        (params["mlstm"], params["slstm"], cache["mlstm"], cache["slstm"]),
        groups)
    return x, {"mlstm": new_m, "slstm": new_s}


def xlstm_prefill(params, tokens, cfg: ArchConfig, mesh=None):
    cache = init_xlstm_cache(cfg, tokens.shape[0], 0, device=tokens.device)
    x, new_cache = xlstm_apply_with_state(params, tokens, cache, cfg, mesh)
    return lm_head(params, x[:, -1:], cfg, mesh)[:, 0], new_cache


def xlstm_decode_step(params, token, cache, cache_len, cfg: ArchConfig,
                      mesh=None):
    del cache_len                    # the recurrent state carries position
    x, new_cache = xlstm_apply_with_state(params, token, cache, cfg, mesh,
                                          chunk=1)
    return lm_head(params, x, cfg, mesh)[:, 0], new_cache


def xlstm_param_pspecs(cfg: ArchConfig, mesh) -> dict:
    dp = dp_axes_of(mesh) or None
    lead2 = (None, None)
    m_spec = {
        "ln": P(*lead2, None),
        "up_proj": P(*lead2, dp, "model"),
        "wq": P(*lead2, None, None, None),
        "wk": P(*lead2, None, None, None),
        "wv": P(*lead2, None, None, None),
        "w_gates": P(*lead2, "model", None),
        "gate_bias": P(*lead2, None),
        "out_norm": P(*lead2, "model"),
        "down_proj": P(*lead2, "model", dp),
    }
    s_spec = {
        "ln": P(None, None),
        "w_in": P(None, dp, "model"),
        "r": P(None, None, None, None),
        "bias": P(None, "model"),
        "out_norm": P(None, None),
        "out_proj": P(None, dp, "model"),
    }
    return {
        "embed": ({"hash_tables": P(None, None, "model")}
                  if cfg.embedding == "bbit_hash"
                  else {"table": P(None, "model")}),
        "final_norm": P(None),
        "lm_head": P(dp, "model"),
        "mlstm": m_spec,
        "slstm": s_spec,
    }
