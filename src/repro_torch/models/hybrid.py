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
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import ParamInit, rmsnorm
from repro_torch.models.transformer import (_dtype, attn_apply,
                                            build_positions, checkpointed,
                                            embed_tokens, ffn_apply,
                                            init_attn_params,
                                            init_embed_params, lm_head)
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


def _mamba_block(lp, x, cfg, state=None, chunk=128):
    h = rmsnorm(x, lp["ln"], cfg.norm_eps)
    y, new_state = ssm_lib.mamba2_forward(
        {k: v for k, v in lp.items() if k != "ln"}, h, cfg,
        h0=None if state is None else state[0],
        conv0=None if state is None else state[1], chunk=chunk)
    return x + y, new_state


def _select_attn(params, g_idx, n_shared):
    return tree_map(lambda p: p[g_idx % n_shared], params["attn"])


def _mamba_stack(cfg, x, layer_params, length, states=None, chunk=128,
                 remat=True, keep=True):
    """Runs ``length`` stacked Mamba2 blocks → (x, their new states
    stacked, or None without ``keep``)."""
    if states is None:
        def body(xi, lp):
            xi, st = _mamba_block(lp, xi, cfg, chunk=chunk)
            return xi, st if keep else None
        xs = layer_params
    else:
        def body(xi, inp):
            lp, st = inp
            return _mamba_block(lp, xi, cfg, state=st, chunk=chunk)
        xs = (layer_params, states)
    return _loop(cfg, _remat(cfg, body) if remat else body, x, xs, length)


def hybrid_forward_train(params, tokens, cfg: ArchConfig):
    x, _ = _hybrid_run(params, tokens, cfg, "train")
    return lm_head(params, x, cfg)


def _hybrid_run(params, tokens, cfg: ArchConfig, mode: str):
    """train | prefill over the whole stack → (x, cache or None)."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = build_positions(cfg, b, s, device=tokens.device)
    groups, per, tail = _hybrid_layout(cfg)
    nsh = cfg.hybrid_shared_attn_blocks

    def group_body(xc, inp):
        g_idx, g_params = inp
        ap = _select_attn(params, g_idx, nsh)
        xc, kv = attn_apply(ap, xc, cfg=cfg, positions=positions,
                            mode=mode)
        xc = ffn_apply(ap, xc, cfg)
        keep = mode == "prefill"
        xc, states = _mamba_stack(cfg, xc, g_params, per, keep=keep)
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
                                      keep=mode == "prefill")
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


def hybrid_decode_step(params, token, cache, cache_len, cfg: ArchConfig):
    """One token: the attention caches are written in place, the Mamba2
    states replaced → (logits (B,V), the new cache)."""
    b = token.shape[0]
    x = embed_tokens(params, token, cfg)
    positions = build_positions(cfg, b, 1, offset=cache_len,
                                device=token.device)
    groups, per, tail = _hybrid_layout(cfg)
    nsh = cfg.hybrid_shared_attn_blocks

    def group_body(xc, inp):
        g_idx, g_params, g_state, g_kv = inp
        ap = _select_attn(params, g_idx, nsh)
        xc, new_kv = attn_apply(ap, xc, cfg=cfg, positions=positions,
                                mode="decode", cache=g_kv,
                                cache_len=cache_len)
        xc = ffn_apply(ap, xc, cfg)
        xc, new_states = _mamba_stack(cfg, xc, g_params, per, g_state,
                                      chunk=1, remat=False)
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
            chunk=1, remat=False)
    return lm_head(params, x, cfg)[:, 0], new_cache


def hybrid_prefill(params, tokens, cfg: ArchConfig):
    """→ (last logits (B,V), cache at len = tokens.shape[1])."""
    x, cache = _hybrid_run(params, tokens, cfg, "prefill")
    return lm_head(params, x[:, -1:], cfg)[:, 0], cache


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


def _mlstm_block(lp, x, cfg, state=None, chunk=128):
    h = rmsnorm(x, lp["ln"], cfg.norm_eps)
    y, st = xlstm_lib.mlstm_forward(
        {k: v for k, v in lp.items() if k != "ln"}, h, cfg, state=state,
        chunk=chunk)
    return x + y, st


def _slstm_block(lp, x, cfg, state=None):
    h = rmsnorm(x, lp["ln"], cfg.norm_eps)
    y, st = xlstm_lib.slstm_forward(
        {k: v for k, v in lp.items() if k != "ln"}, h, cfg, state=state)
    return x + y, st


def xlstm_forward_train(params, tokens, cfg: ArchConfig):
    x = embed_tokens(params, tokens, cfg)
    groups, per = _xlstm_layout(cfg)

    def group_body(xc, inp):
        g_m, g_s = inp

        def m_body(xi, lp):
            xi, _ = _mlstm_block(lp, xi, cfg)
            return xi, None

        xc, _ = _loop(cfg, _remat(cfg, m_body), xc, g_m, per)
        xc, _ = _slstm_block(g_s, xc, cfg)
        return xc, None

    x, _ = _loop(cfg, _remat(cfg, group_body), x,
                 (params["mlstm"], params["slstm"]), groups)
    return lm_head(params, x, cfg)


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
                           chunk=128):
    """Shared prefill/decode: runs tokens through, carrying states."""
    x = embed_tokens(params, tokens, cfg)
    groups, per = _xlstm_layout(cfg)

    def group_body(xc, inp):
        g_m, g_s, st_m, st_s = inp

        def m_body(xi, inp2):
            lp, st = inp2
            return _mlstm_block(lp, xi, cfg, state=st, chunk=chunk)

        xc, new_m = _loop(cfg, m_body, xc, (g_m, st_m), per)
        xc, new_s = _slstm_block(g_s, xc, cfg, state=st_s)
        return xc, (new_m, new_s)

    x, (new_m, new_s) = _loop(
        cfg, group_body, x,
        (params["mlstm"], params["slstm"], cache["mlstm"], cache["slstm"]),
        groups)
    return x, {"mlstm": new_m, "slstm": new_s}


def xlstm_prefill(params, tokens, cfg: ArchConfig):
    cache = init_xlstm_cache(cfg, tokens.shape[0], 0, device=tokens.device)
    x, new_cache = xlstm_apply_with_state(params, tokens, cache, cfg)
    return lm_head(params, x[:, -1:], cfg)[:, 0], new_cache


def xlstm_decode_step(params, token, cache, cache_len, cfg: ArchConfig):
    del cache_len                    # the recurrent state carries position
    x, new_cache = xlstm_apply_with_state(params, token, cache, cfg,
                                          chunk=1)
    return lm_head(params, x, cfg)[:, 0], new_cache
