"""The decoder-LM of the dense, MoE and VLM families, with train,
prefill and decode entry points (counterpart of
``repro/models/transformer.py``).

  * ``forward_train`` — full-sequence causal logits;
  * ``prefill``       — a causal pass returning last-position logits and
                        the KV cache;
  * ``decode_step``   — one token against a cache.

Params are a nested dict of tensors in the reference's tree; the layers
are stacked on a leading (n_layers, ...) axis, as ``jax.vmap`` init
stacks them, and ``_scan_layers`` runs them one slice at a time (the
``scan_layers`` setting only changes how the reference loops them).

One device.  The reference's mesh paths (``maybe_shard``, the pspecs,
``_pad_heads_for_tp``) wait for ROADMAP A6c: these functions take no
``mesh``, and ``models/api.py`` refuses one.

Matmuls are ``torch.matmul`` (the reference leaves them to XLA) and the
port sets no backend flag: on the card a bfloat16 GEMM may reduce in
reduced precision (torch's ``allow_bf16_reduced_precision_reduction``
default), and a float32 one runs without TF32 unless the process allows
it (``models/linear.py::full_float32_matmul`` pins that for a block).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (ParamInit, apply_rope,
                                       blockwise_attention,
                                       hashed_embed_lookup,
                                       hashed_embed_params, rmsnorm)
from repro_torch.tree import leaves, tree_map, tree_stack

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype={cfg.dtype!r}: the port's LM zoo runs "
                         f"{' or '.join(DTYPES)}")
    return DTYPES[cfg.dtype]


def _save_matmuls(ctx, op, *args, **kwargs):
    """The 'dots' policy: keep matmul outputs, recompute the rest."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn: Callable, policy: str = "full") -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) while
    autograd records: 'full' keeps only its inputs for backward, 'dots'
    keeps the matmul outputs too (the reference's
    ``dots_with_no_batch_dims_saveable``)."""
    def wrapped(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in leaves(args))):
            return fn(*args)
        kw = {}
        if policy == "dots":
            kw["context_fn"] = lambda: (
                torch_checkpoint.create_selective_checkpoint_contexts(
                    _save_matmuls))
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                           **kw)
    return wrapped


def remat_wrap(cfg: ArchConfig, fn: Callable) -> Callable:
    """``checkpointed`` with the config's policy, or ``fn`` itself."""
    if not cfg.remat:
        return fn
    return checkpointed(fn, "dots" if cfg.remat_policy == "dots" else "full")


# ---------------------------------------------------------------------------
# attention + mlp blocks
# ---------------------------------------------------------------------------
def init_attn_params(cfg: ArchConfig, init: ParamInit, dtype,
                     with_ffn: bool = True, cross: bool = False,
                     lead: tuple = ()) -> dict:
    """One block's params, stacked on ``lead``."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    sc = d ** -0.5
    n = init.normal
    p = {
        "ln1": init.full(lead + (d,), 1.0, dtype),
        "wq": n(lead + (d, h * hd), sc, dtype),
        "wk": n(lead + (d, kv * hd), sc, dtype),
        "wv": n(lead + (d, kv * hd), sc, dtype),
        "wo": n(lead + (h * hd, d), (h * hd) ** -0.5, dtype),
    }
    if cross:
        p.update({
            "ln_x": init.full(lead + (d,), 1.0, dtype),
            "xq": n(lead + (d, h * hd), sc, dtype),
            "xk": n(lead + (d, kv * hd), sc, dtype),
            "xv": n(lead + (d, kv * hd), sc, dtype),
            "xo": n(lead + (h * hd, d), (h * hd) ** -0.5, dtype),
        })
    if with_ffn:
        p["ln2"] = init.full(lead + (d,), 1.0, dtype)
        if cfg.is_moe and not cross:
            p["moe"] = moe_lib.init_moe_params(cfg, init, dtype, lead)
        else:
            f = cfg.d_ff
            p["mlp"] = {"w_gate": n(lead + (d, f), sc, dtype),
                        "w_up": n(lead + (d, f), sc, dtype),
                        "w_down": n(lead + (f, d), f ** -0.5, dtype)}
    return p


def _project_qkv(lp, h, cfg: ArchConfig, prefix=""):
    b, s, _ = h.shape
    hd = cfg.head_dim
    wq = lp[prefix + ("q" if prefix else "wq")]
    wk = lp[prefix + ("k" if prefix else "wk")]
    wv = lp[prefix + ("v" if prefix else "wv")]
    q = (h @ wq).reshape(b, s, cfg.n_heads, hd)
    k = (h @ wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ wv).reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def cache_write_start(cache_len, max_len: int, s: int) -> int:
    """Where ``s`` new positions go in a cache of ``max_len``: at
    ``cache_len`` (a negative one counted from the end), clamped into
    [0, max_len − s], as ``jax.lax.dynamic_update_slice_in_dim`` places
    its update.  A write of one position at ``max_len − 1`` lands there;
    ``greedy_generate`` never asks for more."""
    start = int(cache_len)
    if start < 0:
        start += max_len
    return min(max(start, 0), max_len - s)


def attn_apply(lp: dict, x: torch.Tensor, *, cfg: ArchConfig,
               positions: torch.Tensor, mode: str = "train",
               cache: Optional[dict] = None, cache_len=None,
               causal: bool = True):
    """Self-attention block → (x', new_cache_or_None).  ``mode`` train |
    prefill | decode; in decode the new K/V are written into ``cache``
    (k, v (B, Smax, KV, hd)) in place, and that cache is returned."""
    b, s, _ = x.shape
    h_in = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(lp, h_in, cfg)
    q, k = apply_rope(q, k, positions, variant=cfg.rope_variant,
                      theta=cfg.rope_theta,
                      mrope_sections=cfg.mrope_sections)
    if mode != "train" and cfg.kv_repeat_to > cfg.n_kv_heads:
        # the exact GQA transform: each KV head r times
        r = cfg.kv_repeat_to // cfg.n_kv_heads
        k = torch.repeat_interleave(k, r, dim=2)
        v = torch.repeat_interleave(v, r, dim=2)
    new_cache = None
    if mode == "decode":
        ck, cv = cache["k"], cache["v"]
        at = cache_write_start(cache_len, ck.shape[1], s)
        ck[:, at:at + s] = k.to(ck.dtype)
        cv[:, at:at + s] = v.to(cv.dtype)
        out = blockwise_attention(
            q, ck, cv, causal=False, kv_valid_len=cache_len + s,
            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
            impl=cfg.attn_impl)
        new_cache = cache
    else:
        out = blockwise_attention(
            q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk, impl=cfg.attn_impl)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    y = out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp["wo"]
    return x + y, new_cache


def cross_attn_apply(lp, x, enc_kv, cfg: ArchConfig):
    """Cross-attention with precomputed encoder K/V {k, v}."""
    b, s, _ = x.shape
    h_in = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
    hd = cfg.head_dim
    q = (h_in @ lp["xq"]).reshape(b, s, cfg.n_heads, hd)
    out = blockwise_attention(
        q, enc_kv["k"], enc_kv["v"], causal=False,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
        impl=cfg.attn_impl)
    return x + out.reshape(b, s, cfg.n_heads * hd) @ lp["xo"]


def encode_cross_kv(lp, enc_out, cfg: ArchConfig):
    b, f, _ = enc_out.shape
    hd = cfg.head_dim
    k = (enc_out @ lp["xk"]).reshape(b, f, cfg.n_kv_heads, hd)
    v = (enc_out @ lp["xv"]).reshape(b, f, cfg.n_kv_heads, hd)
    return {"k": k, "v": v}


def ffn_apply(lp, x, cfg: ArchConfig, serving: bool = False):
    h_in = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        y = moe_lib.moe_ffn(h_in, lp["moe"], cfg, serving=serving)
    else:
        m = lp["mlp"]
        hidden = F.silu(h_in @ m["w_gate"]) * (h_in @ m["w_up"])
        y = hidden @ m["w_down"]
    return x + y


def dense_layer_apply(lp, x, *, cfg, positions, mode="train", cache=None,
                      cache_len=None, causal=True):
    x, new_cache = attn_apply(lp, x, cfg=cfg, positions=positions,
                              mode=mode, cache=cache, cache_len=cache_len,
                              causal=causal)
    x = ffn_apply(lp, x, cfg, serving=(mode != "train"))
    return x, new_cache


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------
def init_embed_params(cfg: ArchConfig, init: ParamInit, dtype) -> dict:
    if cfg.embedding == "bbit_hash":
        emb = hashed_embed_params(cfg.vocab, cfg.d_model, cfg.hash_k,
                                  cfg.hash_b, init, dtype)
    else:
        emb = {"table": init.normal((cfg.vocab, cfg.d_model), 0.02, dtype)}
    return {
        "embed": emb,
        "final_norm": init.full((cfg.d_model,), 1.0, dtype),
        "lm_head": init.normal((cfg.d_model, cfg.vocab),
                               cfg.d_model ** -0.5, dtype),
    }


def embed_tokens(params, tokens, cfg: ArchConfig):
    if cfg.embedding == "bbit_hash":
        return hashed_embed_lookup(params["embed"], tokens, cfg.hash_k,
                                   cfg.hash_b)
    return params["embed"]["table"][tokens]


def lm_head(params, x, cfg: ArchConfig):
    return rmsnorm(x, params["final_norm"], cfg.norm_eps) @ params["lm_head"]


def xent_loss(logits, targets):
    """Mean cross-entropy; logits (B,S,V) any dtype, targets (B,S).  The
    reference takes the gold logit by a one-hot contraction (to keep a
    vocab-sharded gather off its mesh); for finite logits a gather gives
    the same float32 value."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.to(torch.int64)[..., None])[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# positions (standard / mrope-with-vision-prefix)
# ---------------------------------------------------------------------------
def build_positions(cfg: ArchConfig, batch: int, seq: int, offset=0,
                    device=None):
    """Absolute positions (int32); ``offset`` is the first token's index
    (decode)."""
    idx = torch.arange(seq, dtype=torch.int32, device=device) + int(offset)
    if cfg.rope_variant != "mrope":
        return idx[None, :].expand(batch, seq)
    # M-RoPE: the first frontend_len absolute positions are a patch grid
    # (t=0, h, w); text continues with equal (t,h,w) ids after it.
    n_vis = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
    side = max(int(n_vis ** 0.5), 1)
    vis = idx < n_vis
    text = idx - n_vis + 1
    t_pos = torch.where(vis, torch.zeros_like(idx), text)
    h_pos = torch.where(vis, idx // side, text)
    w_pos = torch.where(vis, idx % side, text)
    pos3 = torch.stack([t_pos, h_pos, w_pos], dim=-1)[None]
    return pos3.expand(batch, seq, 3)


# ---------------------------------------------------------------------------
# the decoder-only families: dense / moe / vlm
# ---------------------------------------------------------------------------
def init_decoder_params(cfg: ArchConfig, init: ParamInit) -> dict:
    dtype = _dtype(cfg)
    params = init_embed_params(cfg, init, dtype)
    params["layers"] = init_attn_params(cfg, init, dtype,
                                        lead=(cfg.n_layers,))
    return params


def _scan_layers(params, x, body, cfg: ArchConfig, ys_in=None):
    """Runs ``body(x, layer params[, ys_in slice])`` over the stacked
    layers, remat-wrapped; returns (x, its outputs stacked, or None)."""
    fn = remat_wrap(cfg, body)
    ys = []
    for i in range(cfg.n_layers):
        lp = tree_map(lambda p: p[i], params["layers"])
        if ys_in is None:
            x, y = fn(x, lp)
        else:
            x, y = fn(x, (lp, tree_map(lambda p: p[i], ys_in)))
        ys.append(y)
    return x, tree_stack(ys, torch.stack)


def _embed_with_vision(params, tokens, cfg, vision_embeds):
    x = embed_tokens(params, tokens, cfg)
    if vision_embeds is not None and cfg.frontend == "vision_stub":
        n_vis = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, n_vis:]], dim=1)
    return x


def forward_train(params, tokens, cfg: ArchConfig,
                  vision_embeds: Optional[torch.Tensor] = None):
    """tokens (B,S) → logits (B,S,V)."""
    b, s = tokens.shape
    x = _embed_with_vision(params, tokens, cfg, vision_embeds)
    positions = build_positions(cfg, b, s, device=tokens.device)

    def body(xc, lp):
        xc, _ = dense_layer_apply(lp, xc, cfg=cfg, positions=positions,
                                  mode="train")
        return xc, None

    x, _ = _scan_layers(params, x, body, cfg)
    return lm_head(params, x, cfg)


def prefill(params, tokens, cfg: ArchConfig,
            vision_embeds: Optional[torch.Tensor] = None):
    """→ (last-position logits (B,V), cache {k, v} (L,B,S,KV,hd))."""
    b, s = tokens.shape
    x = _embed_with_vision(params, tokens, cfg, vision_embeds)
    positions = build_positions(cfg, b, s, device=tokens.device)

    def body(xc, lp):
        return dense_layer_apply(lp, xc, cfg=cfg, positions=positions,
                                 mode="prefill")

    x, cache = _scan_layers(params, x, body, cfg)
    return lm_head(params, x[:, -1:], cfg)[:, 0], cache


def decode_step(params, token, cache, cache_len, cfg: ArchConfig):
    """token (B,1) against cache {k, v} (L,B,Smax,KV,hd), written in
    place at ``cache_len`` → (logits (B,V), the cache)."""
    b = token.shape[0]
    x = embed_tokens(params, token, cfg)
    positions = build_positions(cfg, b, 1, offset=cache_len,
                                device=token.device)

    def body(xc, lp_cache):
        lp, cache_l = lp_cache
        xc, _ = dense_layer_apply(lp, xc, cfg=cfg, positions=positions,
                                  mode="decode", cache=cache_l,
                                  cache_len=cache_len)
        return xc, None

    x, _ = _scan_layers(params, x, body, cfg, ys_in=cache)
    return lm_head(params, x, cfg)[:, 0], cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    dtype = dtype or _dtype(cfg)
    kv = max(cfg.n_kv_heads, cfg.kv_repeat_to or 0)
    shape = (cfg.n_layers, batch, max_len, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
