"""The decoder-LM of the dense, MoE and VLM families, with train,
prefill and decode entry points (counterpart of
``repro/models/transformer.py``).

  * ``forward_train`` — full-sequence causal logits;
  * ``prefill``       — a causal pass returning last-position logits and
                        the KV cache;
  * ``decode_step``   — one token against a cache.

An ``MLAConfig`` (DeepSeek-V3, Kimi K2) runs ``mla_forward_train`` /
``mla_prefill`` / ``mla_decode_step`` instead: multi-head latent
attention with YaRN rope, its dense layers then its MoE layers (two
stacks, ``dense_layers`` and ``layers``), the held-expert MoE layer
(``moe.held_moe_ffn``).  Prefill decompresses K and V from the latent and
runs one fused causal attention (SDPA's cuDNN kernel on the card);
decode attends over the latent cache {c_kv, k_rope} with the
up-projections absorbed.  One card only: on a mesh it raises.

Params are a nested dict of tensors in the reference's tree; the layers
are stacked on a leading (n_layers, ...) axis, as ``jax.vmap`` init
stacks them, and ``_scan_layers`` runs them one slice at a time (the
``scan_layers`` setting only changes how the reference loops them).

On a mesh (a ``DeviceMesh`` with the reference's axis names, see
``distributed/shardings.py``) the params, caches and batches are
DTensors laid out by ``decoder_param_pspecs`` / the cache and batch
specs: TP over 'model', FSDP over the data axes.  The dense parts
(projections, norms, MLP, head) run as DTensor ops: each weight's data
shards are gathered just before its matmul (``gather_fsdp``, ZeRO-3)
and ``maybe_shard`` redistributes activations where the reference
constrains them (pjit's auto-sharding becomes DTensor's propagation).
Attention runs on local shards (``_attention``): batch over the data
axes and heads over
'model' when they divide (KV heads a rank needs are picked from the
replicated K/V when only the query heads divide), otherwise the heads
stay whole on every model rank.  A decode cache whose heads do not
divide 'model' is sharded over its sequence instead, as in the
reference; each rank then attends over its slice and the partial
softmax stats merge exactly (``merge_partial_attention``).  MoE layers
dispatch with expert parallelism (``models/moe.py``).  Callers, and a
backward pass through a mesh loss, run under
``shardings.implicit_replication`` (the API functions and the step
builders do), so plain tensors the model builds (positions, masks) count
as replicated.

Matmuls are ``torch.matmul`` (the reference leaves them to XLA) and the
port sets no backend flag: on the card a bfloat16 GEMM may reduce in
reduced precision (torch's ``allow_bf16_reduced_precision_reduction``
default), and a float32 one runs without TF32 unless the process allows
it (``models/linear.py::full_float32_matmul`` pins that for a block).
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import obs
from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.distributed import shardings as sh
from repro_torch.distributed.sequence_parallel import merge_partial_attention
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (ParamInit, _attend_block,
                                       _init_block, apply_rope,
                                       apply_rotation,
                                       blockwise_attention,
                                       hashed_embed_lookup,
                                       hashed_embed_params, rmsnorm,
                                       swiglu, yarn_mscale, yarn_rotation)
from repro_torch.tree import leaves, tree_map, tree_stack, unflatten

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
P = sh.P


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------
def dp_axes_of(mesh) -> tuple:
    if mesh is None:
        return ()
    return sh.data_axes(mesh)


def maybe_shard(x: torch.Tensor, mesh, *spec) -> torch.Tensor:
    """with_sharding_constraint, skipping non-divisible dims: a DTensor
    redistributed to ``spec`` (a plain tensor taken as replicated)."""
    if mesh is None:
        return x
    return sh.constrain(x, mesh, *sh.divisible_spec(x.shape, mesh, spec))


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
    def on_mesh(*args):
        # the recomputation runs inside backward, outside the caller's
        # implicit replication (models/api.py), so DTensor bodies enter
        # it themselves
        with sh.implicit_replication():
            return fn(*args)

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
        body = on_mesh if any(sh.is_dtensor(t) for t in leaves(args)) \
            else fn
        return torch_checkpoint.checkpoint(body, *args, use_reentrant=False,
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


def _split_heads(y, n_heads: int, hd: int, mesh):
    """(B, S, n_heads·hd) → (B, S, n_heads, hd).  On a mesh whose
    'model' axis does not divide the heads, the features are gathered
    over 'model' first: a shard boundary would fall inside a head."""
    b, s, _ = y.shape
    if mesh is not None and n_heads % sh.mp_size(mesh):
        y = maybe_shard(y, mesh, dp_axes_of(mesh), None, None)
    return y.reshape(b, s, n_heads, hd)


def _merge_heads(out, mesh):
    """(B, S, H, hd) → (B, S, H·hd).  On a mesh whose 'model' axis does
    not divide the heads the merged features are pinned whole over
    'model', so that the gradient coming back from the next matmul is
    gathered before it is split into heads again."""
    b, s, h, hd = out.shape
    y = out.reshape(b, s, h * hd)
    if mesh is not None and h % sh.mp_size(mesh):
        y = maybe_shard(y, mesh, dp_axes_of(mesh), None, None)
    return y


def _project_qkv(lp, h, cfg: ArchConfig, mesh=None, prefix=""):
    b, s, _ = h.shape
    hd = cfg.head_dim
    wq = sh.gather_fsdp(lp[prefix + ("q" if prefix else "wq")], mesh)
    wk = sh.gather_fsdp(lp[prefix + ("k" if prefix else "wk")], mesh)
    wv = sh.gather_fsdp(lp[prefix + ("v" if prefix else "wv")], mesh)
    q = _split_heads(h @ wq, cfg.n_heads, hd, mesh)
    k = _split_heads(h @ wk, cfg.n_kv_heads, hd, mesh)
    v = _split_heads(h @ wv, cfg.n_kv_heads, hd, mesh)
    dp = dp_axes_of(mesh)
    q = maybe_shard(q, mesh, dp, None, "model", None)
    k = maybe_shard(k, mesh, dp, None, "model", None)
    v = maybe_shard(v, mesh, dp, None, "model", None)
    return q, k, v


def _pad_heads_for_tp(q, k, v, cfg: ArchConfig, mesh):
    """Group-aware head padding so attention shards over 'model'.

    When n_heads doesn't divide the model axis, each kv head is
    replicated r = model/kv times and each q-group padded from g to
    ceil(g/r) per kv-replica (zero rows, sliced off after).  Returns
    (q', k', v', (g, g_new, r) or None)."""
    mdl = sh.mp_size(mesh)
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if h % mdl == 0 or mdl % kv != 0:
        return q, k, v, None
    r = mdl // kv
    g = h // kv
    g_new = -(-g // r)
    dp = dp_axes_of(mesh)
    b = q.shape[0]
    bspec = sh.divisible_spec((b,), mesh, (dp,))[0]
    spec = P(bspec, None, None, None)

    def pad(q, k, v):
        bl, s, _, hd = q.shape
        qg = q.reshape(bl, s, kv, g, hd)
        qg = F.pad(qg, (0, 0, 0, r * g_new - g))
        return (qg.reshape(bl, s, kv * r * g_new, hd),
                torch.repeat_interleave(k, r, dim=2),
                torch.repeat_interleave(v, r, dim=2))

    q, k, v = sh.local_apply(pad, mesh, (spec, spec, spec),
                             (spec, spec, spec), q, k, v)
    q = maybe_shard(q, mesh, dp, None, "model", None)
    k = maybe_shard(k, mesh, dp, None, "model", None)
    v = maybe_shard(v, mesh, dp, None, "model", None)
    return q, k, v, (g, g_new, r)


def _unpad_heads(out, pad_info, cfg: ArchConfig, mesh=None):
    if pad_info is None:
        return out
    g, g_new, r = pad_info
    kv, h = cfg.n_kv_heads, cfg.n_heads

    def unpad(o):
        b, s, _, hd = o.shape
        og = o.reshape(b, s, kv, r * g_new, hd)[:, :, :, :g]
        return og.reshape(b, s, h, hd)

    if mesh is None:
        return unpad(out)
    bspec = sh.divisible_spec((out.shape[0],), mesh, (dp_axes_of(mesh),))[0]
    spec = P(bspec, None, None, None)
    return sh.local_apply(unpad, mesh, (spec,), spec, out)


def _head_layout(mesh, b: int, h: int, kv: int):
    """(batch entry, q heads over 'model'?, kv heads over 'model'?) for
    attention on local shards."""
    bspec = sh.divisible_spec((b,), mesh, (dp_axes_of(mesh),))[0]
    mdl = sh.mp_size(mesh)
    q_split = h % mdl == 0
    return bspec, q_split, q_split and kv % mdl == 0


def _local_kv_heads(k, h: int, kv: int, mdl: int, m: int):
    """The K/V heads that this model rank's h/mdl query heads read, from
    all ``kv`` heads: an exact GQA regrouping (each query head gets its
    own copy of its group's KV head)."""
    hl = h // mdl
    idx = (m * hl + torch.arange(hl, device=k.device)) // (h // kv)
    return k[:, :, idx]


def _attention(q, k, v, cfg: ArchConfig, mesh, *, causal: bool):
    """Blockwise attention, on local shards over a mesh (see the module
    docstring)."""
    kw = dict(causal=causal, q_chunk=cfg.attn_q_chunk,
              kv_chunk=cfg.attn_kv_chunk, impl=cfg.attn_impl)
    if mesh is None:
        return blockwise_attention(q, k, v, **kw)
    b, _, h, _ = q.shape
    kv = k.shape[2]
    bspec, q_split, kv_split = _head_layout(mesh, b, h, kv)
    hspec = "model" if q_split else None
    qs = P(bspec, None, hspec, None)
    ks = P(bspec, None, "model" if kv_split else None, None)
    mdl = sh.mp_size(mesh)

    def local(q, k, v):
        if q_split and not kv_split:
            m = sh.axis_index(mesh, "model")
            k = _local_kv_heads(k, h, kv, mdl, m)
            v = _local_kv_heads(v, h, kv, mdl, m)
        return blockwise_attention(q, k, v, **kw)

    return sh.local_apply(local, mesh, (qs, ks, ks), qs, q, k, v,
                          grad_partial=("model",) if q_split and not
                          kv_split else ())


def _partial_attention(q, k, v, valid, kv_offset: int, kv_chunk: int):
    """Online-softmax stats of q (B,1,H,D) over the keys k/v (B,S_l,KV,D)
    whose global positions start at ``kv_offset``, keys at or past
    ``valid`` masked → (max (B,H,1), denom (B,H,1), num (B,1,H,D))."""
    b, sq, h, d = q.shape
    s_l = k.shape[1]
    m, l, acc = _init_block(b, h, sq, d, q.device)
    q_pos = torch.zeros(sq, dtype=torch.int64, device=q.device)
    for lo in range(0, s_l, kv_chunk):
        hi = min(lo + kv_chunk, s_l)
        kv_pos = kv_offset + lo + torch.arange(hi - lo, device=q.device)
        m, l, acc = _attend_block(q, k[:, lo:hi], v[:, lo:hi], m, l, acc,
                                  q_pos, kv_pos, False, valid)
    return m, l, acc


def _mesh_decode_attention(q, k, v, cache, cache_len, cfg: ArchConfig,
                           mesh):
    """The decode step's cache write and attention on a mesh, on local
    shards: the new K/V (repeated to ``kv_repeat_to`` heads if asked)
    are written into the rank's slice of the cache in place.  A cache
    sharded over its heads attends locally; one sharded over its
    sequence (heads that do not divide 'model') attends over its slice
    and merges the partial stats over 'model'."""
    b, s, h, hd = q.shape
    ck, cv = cache["k"], cache["v"]
    max_len, kv_eff = ck.shape[1], ck.shape[2]
    mdl = sh.mp_size(mesh)
    bspec = sh.divisible_spec((b,), mesh, (dp_axes_of(mesh),))[0]
    heads = kv_eff % mdl == 0
    seq_split = not heads and max_len % mdl == 0 and mdl > 1
    cspec = P(bspec, None, "model" if heads else None, None) if not \
        seq_split else P(bspec, "model", None, None)
    rep = P(bspec, None, None, None)
    at = cache_write_start(cache_len, max_len, s)
    valid = cache_len + s
    r = kv_eff // k.shape[2]

    def local(q, k, v, ck, cv):
        if r > 1:
            k = torch.repeat_interleave(k, r, dim=2)
            v = torch.repeat_interleave(v, r, dim=2)
        m = sh.axis_index(mesh, "model") if "model" in \
            sh.axis_names(mesh) else 0
        if heads:
            kl, hl = kv_eff // mdl, h // mdl
            k, v = k[:, :, m * kl:(m + 1) * kl], v[:, :, m * kl:(m + 1) * kl]
            q = q[:, :, m * hl:(m + 1) * hl]
            ck[:, at:at + s] = k.to(ck.dtype)
            cv[:, at:at + s] = v.to(cv.dtype)
            return blockwise_attention(
                q, ck, cv, causal=False, kv_valid_len=valid,
                q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
                impl=cfg.attn_impl)
        s_l = ck.shape[1]
        lo = m * s_l if seq_split else 0
        for j in range(s):         # the positions this rank holds
            pos = at + j
            if lo <= pos < lo + s_l:
                ck[:, pos - lo] = k[:, j].to(ck.dtype)
                cv[:, pos - lo] = v[:, j].to(cv.dtype)
        mx, den, num = _partial_attention(q, ck, cv, valid, lo,
                                          cfg.attn_kv_chunk)
        if seq_split:
            out = merge_partial_attention(
                mx, den, num.transpose(1, 2), sh.group_of(mesh, "model"))
        else:
            out = num.transpose(1, 2) / torch.clamp_min(den, 1e-20)[..., None]
        return out.transpose(1, 2).to(q.dtype)

    out_spec = P(bspec, None, "model" if heads else None, None)
    return sh.local_apply(local, mesh, (rep, rep, rep, cspec, cspec),
                          out_spec, q, k, v, ck, cv)


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
               mesh=None, positions: torch.Tensor, mode: str = "train",
               cache: Optional[dict] = None, cache_len=None,
               causal: bool = True):
    """Self-attention block → (x', new_cache_or_None).  ``mode`` train |
    prefill | decode; in decode the new K/V are written into ``cache``
    (k, v (B, Smax, KV, hd)) in place, and that cache is returned."""
    b, s, _ = x.shape
    h_in = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(lp, h_in, cfg, mesh)
    q, k = apply_rope(q, k, positions, variant=cfg.rope_variant,
                      theta=cfg.rope_theta,
                      mrope_sections=cfg.mrope_sections)
    pad_info = None
    if cfg.attn_pad_heads and mesh is not None and mode == "train":
        q, k, v, pad_info = _pad_heads_for_tp(q, k, v, cfg, mesh)
    new_cache = None
    if mode == "decode" and mesh is not None:
        # the repeat to kv_repeat_to heads happens on the local shards
        out = _mesh_decode_attention(q, k, v, cache, cache_len, cfg, mesh)
        new_cache = cache
    else:
        if mode != "train" and cfg.kv_repeat_to > cfg.n_kv_heads:
            # the exact GQA transform: each KV head r times
            r = cfg.kv_repeat_to // cfg.n_kv_heads
            if mesh is None:
                k = torch.repeat_interleave(k, r, dim=2)
                v = torch.repeat_interleave(v, r, dim=2)
            else:
                bspec = sh.divisible_spec((b,), mesh, (dp_axes_of(mesh),))[0]
                rs = P(bspec, None, None, None)
                k, v = sh.local_apply(
                    lambda k, v: (torch.repeat_interleave(k, r, dim=2),
                                  torch.repeat_interleave(v, r, dim=2)),
                    mesh, (rs, rs), (rs, rs), k, v)
                dp = dp_axes_of(mesh)
                k = maybe_shard(k, mesh, dp, None, "model", None)
                v = maybe_shard(v, mesh, dp, None, "model", None)
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
            out = _attention(q, k, v, cfg, mesh, causal=causal)
            if mode == "prefill":
                new_cache = {"k": k, "v": v}
    out = _unpad_heads(out, pad_info, cfg, mesh)
    y = _merge_heads(out, mesh) @ sh.gather_fsdp(lp["wo"], mesh)
    y = maybe_shard(y, mesh, dp_axes_of(mesh), None, None)
    return x + y, new_cache


def cross_attn_apply(lp, x, enc_kv, cfg: ArchConfig, mesh=None):
    """Cross-attention with precomputed encoder K/V {k, v}."""
    b, s, _ = x.shape
    h_in = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
    hd = cfg.head_dim
    q = _split_heads(h_in @ sh.gather_fsdp(lp["xq"], mesh), cfg.n_heads,
                     hd, mesh)
    out = _attention(q, enc_kv["k"], enc_kv["v"], cfg, mesh, causal=False)
    return x + _merge_heads(out, mesh) @ sh.gather_fsdp(lp["xo"], mesh)


def encode_cross_kv(lp, enc_out, cfg: ArchConfig, mesh=None):
    b, f, _ = enc_out.shape
    hd = cfg.head_dim
    k = _split_heads(enc_out @ sh.gather_fsdp(lp["xk"], mesh),
                     cfg.n_kv_heads, hd, mesh)
    v = _split_heads(enc_out @ sh.gather_fsdp(lp["xv"], mesh),
                     cfg.n_kv_heads, hd, mesh)
    return {"k": k, "v": v}


def ffn_apply(lp, x, cfg: ArchConfig, mesh=None, serving: bool = False):
    h_in = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        y = moe_lib.moe_ffn(h_in, lp["moe"], cfg, mesh, serving=serving)
    else:
        m = lp["mlp"]
        hidden = F.silu(h_in @ sh.gather_fsdp(m["w_gate"], mesh)) * \
            (h_in @ sh.gather_fsdp(m["w_up"], mesh))
        hidden = maybe_shard(hidden, mesh, dp_axes_of(mesh), None, "model")
        y = hidden @ sh.gather_fsdp(m["w_down"], mesh)
    y = maybe_shard(y, mesh, dp_axes_of(mesh), None, None)
    return x + y


def dense_layer_apply(lp, x, *, cfg, mesh=None, positions, mode="train",
                      cache=None, cache_len=None, causal=True):
    x, new_cache = attn_apply(lp, x, cfg=cfg, mesh=mesh,
                              positions=positions, mode=mode, cache=cache,
                              cache_len=cache_len, causal=causal)
    x = ffn_apply(lp, x, cfg, mesh, serving=(mode != "train"))
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


def embed_tokens(params, tokens, cfg: ArchConfig, mesh=None):
    if mesh is not None:
        # the reference replicates the (tiny) token ids for the gather;
        # the output constraint re-shards the embeddings right after
        tokens = maybe_shard(tokens, mesh, *([None] * tokens.dim()))
    if cfg.embedding == "bbit_hash":
        if mesh is None:
            return hashed_embed_lookup(params["embed"], tokens, cfg.hash_k,
                                       cfg.hash_b)
        tables = params["embed"]["hash_tables"]
        ts = P(None, None, *sh.divisible_spec(tables.shape[2:], mesh,
                                           ("model",)))
        tok = P(*([None] * tokens.dim()))
        x = sh.local_apply(
            lambda t, tab: hashed_embed_lookup({"hash_tables": tab}, t,
                                               cfg.hash_k, cfg.hash_b),
            mesh, (tok, ts), P(None, None, ts[2]), tokens, tables)
    else:
        x = params["embed"]["table"][tokens]
    return maybe_shard(x, mesh, dp_axes_of(mesh), None, None)


def lm_head(params, x, cfg: ArchConfig, mesh=None):
    logits = rmsnorm(x, params["final_norm"], cfg.norm_eps) @ \
        sh.gather_fsdp(params["lm_head"], mesh)
    return maybe_shard(logits, mesh, dp_axes_of(mesh), None, "model")


def xent_loss(logits, targets):
    """Mean cross-entropy; logits (B,S,V) any dtype, targets (B,S).  The
    reference takes the gold logit by a one-hot contraction (to keep a
    vocab-sharded gather off its mesh); for finite logits a gather gives
    the same float32 value.  On a mesh (DTensor logits) the vocab stays
    sharded: ``_mesh_xent``."""
    if sh.is_dtensor(logits):
        return _mesh_xent(logits, targets)
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.to(torch.int64)[..., None])[..., 0]
    return torch.mean(logz - gold)


class _VocabParallelXent(torch.autograd.Function):
    """Per-token cross-entropy of float32 logits whose vocab dim is split
    over a process group (``lo`` this rank's first id): the max, the
    sum of exps and the gold logit each reduce over the group in the
    forward; the backward is local (softmax − one-hot on the rank's
    slice)."""

    @staticmethod
    def forward(ctx, lf, tg, group, lo):
        import torch.distributed._functional_collectives as funcol

        def reduce(x, op):
            return x if group is None else funcol.wait_tensor(
                funcol.all_reduce(x, op, group))

        v_l = lf.shape[-1]
        rel = tg.to(torch.int64) - lo
        ok = (rel >= 0) & (rel < v_l)
        safe = torch.where(ok, rel, torch.zeros_like(rel))
        mx = reduce(torch.amax(lf, dim=-1), "max")
        ex = torch.exp(lf - mx[..., None])
        se = reduce(torch.sum(ex, dim=-1), "sum")
        g = torch.gather(lf, -1, safe[..., None])[..., 0]
        gold = reduce(torch.where(ok, g, torch.zeros_like(g)), "sum")
        ctx.save_for_backward(ex, se, safe, ok)
        return torch.log(se) + mx - gold

    @staticmethod
    def backward(ctx, grad):
        ex, se, safe, ok = ctx.saved_tensors
        d = ex / se[..., None]
        d = d.scatter_add(-1, safe[..., None],
                          -ok.to(d.dtype)[..., None])
        return d * grad[..., None], None, None, None


def _mesh_xent(logits, targets):
    """Vocab-parallel cross-entropy: no rank holds the whole (B,S,V);
    the per-token losses come back replicated over 'model' and their
    mean reduces over the data axes."""
    mesh = logits.device_mesh
    dp = dp_axes_of(mesh)
    bspec, _, vspec = sh.divisible_spec(logits.shape, mesh,
                                        (dp, None, "model"))
    split = vspec is not None and "model" in sh.axis_names(mesh)

    def local(lf, tg):
        lo = sh.axis_index(mesh, "model") * lf.shape[-1] if split else 0
        group = sh.group_of(mesh, "model") if split else None
        return _VocabParallelXent.apply(lf, tg, group, lo)

    per = sh.local_apply(local, mesh,
                         (P(bspec, None, vspec), P(bspec, None)),
                         P(bspec, None), logits.to(torch.float32), targets)
    return torch.mean(per)


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


def _embed_with_vision(params, tokens, cfg, vision_embeds, mesh=None):
    x = embed_tokens(params, tokens, cfg, mesh)
    if vision_embeds is not None and cfg.frontend == "vision_stub":
        n_vis = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, n_vis:]], dim=1)
    return x


def forward_train(params, tokens, cfg: ArchConfig, mesh=None,
                  vision_embeds: Optional[torch.Tensor] = None):
    """tokens (B,S) → logits (B,S,V)."""
    b, s = tokens.shape
    x = _embed_with_vision(params, tokens, cfg, vision_embeds, mesh)
    positions = build_positions(cfg, b, s, device=tokens.device)

    def body(xc, lp):
        xc, _ = dense_layer_apply(lp, xc, cfg=cfg, mesh=mesh,
                                  positions=positions, mode="train")
        return xc, None

    x, _ = _scan_layers(params, x, body, cfg)
    return lm_head(params, x, cfg, mesh)


def prefill(params, tokens, cfg: ArchConfig, mesh=None,
            vision_embeds: Optional[torch.Tensor] = None):
    """→ (last-position logits (B,V), cache {k, v} (L,B,S,KV,hd))."""
    b, s = tokens.shape
    x = _embed_with_vision(params, tokens, cfg, vision_embeds, mesh)
    positions = build_positions(cfg, b, s, device=tokens.device)

    def body(xc, lp):
        return dense_layer_apply(lp, xc, cfg=cfg, mesh=mesh,
                                 positions=positions, mode="prefill")

    x, cache = _scan_layers(params, x, body, cfg)
    return lm_head(params, x[:, -1:], cfg, mesh)[:, 0], cache


def decode_step(params, token, cache, cache_len, cfg: ArchConfig,
                mesh=None):
    """token (B,1) against cache {k, v} (L,B,Smax,KV,hd), written in
    place at ``cache_len`` → (logits (B,V), the cache)."""
    b = token.shape[0]
    x = embed_tokens(params, token, cfg, mesh)
    positions = build_positions(cfg, b, 1, offset=cache_len,
                                device=token.device)

    def body(xc, lp_cache):
        lp, cache_l = lp_cache
        xc, _ = dense_layer_apply(lp, xc, cfg=cfg, mesh=mesh,
                                  positions=positions, mode="decode",
                                  cache=cache_l, cache_len=cache_len)
        return xc, None

    x, _ = _scan_layers(params, x, body, cfg, ys_in=cache)
    return lm_head(params, x, cfg, mesh)[:, 0], cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    dtype = dtype or _dtype(cfg)
    kv = max(cfg.n_kv_heads, cfg.kv_repeat_to or 0)
    shape = (cfg.n_layers, batch, max_len, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# multi-head latent attention: an MLAConfig (DeepSeek-V3, Kimi K2)
# ---------------------------------------------------------------------------
# bytes of the latent caches init_mla_cache allocates
CACHE_BYTES = obs.counter("lm.cache_bytes")


def _refuse_mesh(cfg: ArchConfig, mesh) -> None:
    if mesh is not None:
        raise ValueError(f"{cfg.name}: latent attention runs on one card; "
                         "the port has no mesh path for it")


def mla_softmax_scale(cfg: MLAConfig) -> float:
    """(nope + rope)^−½, times YaRN's mscale(factor, mscale_all_dim)²."""
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
         if cfg.rope_mscale_all_dim else 1.0)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def _mla_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """RMSNorm as ``layers.rmsnorm`` computes it (float32 inside), in one
    call (four a layer, and a decode step's host time is its calls)."""
    return F.rms_norm(x, (x.shape[-1],), scale, eps)


def _mla_rotation(cfg: MLAConfig, positions: torch.Tensor):
    """YaRN's rotation of the rope dims at ``positions``, for every layer."""
    return yarn_rotation(positions, cfg.qk_rope_head_dim, cfg.rope_theta,
                         (cfg.rope_factor, cfg.rope_original_max_pos,
                          cfg.rope_beta_fast, cfg.rope_beta_slow,
                          cfg.rope_mscale, cfg.rope_mscale_all_dim))


def init_mla_layer_params(cfg: MLAConfig, init: ParamInit, dtype,
                          lead: tuple, dense: bool) -> dict:
    """One MLA block's params, stacked on ``lead``: the query's and the
    latent's down- and up-projections with their norms, the output
    projection, then a dense SwiGLU (``dense``) or the held-expert MoE."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    n, one = init.normal, lambda w: init.full(lead + (w,), 1.0, dtype)
    p = {
        "ln1": one(d),
        "wq_a": n(lead + (d, ql), d ** -0.5, dtype),
        "q_ln": one(ql),
        "wq_b": n(lead + (ql, h * (nope + rope)), ql ** -0.5, dtype),
        "wkv_a": n(lead + (d, kl + rope), d ** -0.5, dtype),
        "kv_ln": one(kl),
        "wkv_b": n(lead + (kl, h * (nope + vd)), kl ** -0.5, dtype),
        "wo": n(lead + (h * vd, d), (h * vd) ** -0.5, dtype),
        "ln2": one(d),
    }
    if dense:
        f = cfg.d_ff
        p["mlp"] = {"w_gate": n(lead + (d, f), d ** -0.5, dtype),
                    "w_up": n(lead + (d, f), d ** -0.5, dtype),
                    "w_down": n(lead + (f, d), f ** -0.5, dtype)}
    else:
        p["moe"] = moe_lib.init_held_moe_params(cfg, init, dtype, lead)
    return p


def init_mla_params(cfg: MLAConfig, init: ParamInit) -> dict:
    dtype = _dtype(cfg)
    params = init_embed_params(cfg, init, dtype)
    params["dense_layers"] = init_mla_layer_params(
        cfg, init, dtype, (cfg.first_k_dense,), dense=True)
    params["layers"] = init_mla_layer_params(
        cfg, init, dtype, (cfg.n_moe_layers,), dense=False)
    return params


def _mla_latents(lp, h, cfg: MLAConfig, rotation):
    """h (B,S,d), normed → q_nope (B,S,H,nope), q_rope (B,S,H,rope)
    rotated, c_kv (B,S,kv_lora) normed, k_rope (B,S,rope) rotated: what
    the cache keeps is c_kv and k_rope."""
    b, s, _ = h.shape
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = _mla_norm(h @ lp["wq_a"], lp["q_ln"], cfg.norm_eps)
    q = (cq @ lp["wq_b"]).view(b, s, cfg.n_heads, nope + rope)
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    c_kv, k_rope = (h @ lp["wkv_a"]).split([cfg.kv_lora_rank, rope], dim=-1)
    c_kv = _mla_norm(c_kv, lp["kv_ln"], cfg.norm_eps)
    return (q_nope, apply_rotation(q_rope, rotation), c_kv,
            apply_rotation(k_rope[:, :, None], rotation)[:, :, 0])


def _causal_attention(q, k, v, scale: float):
    """q, k (B,S,H,Dqk), v (B,S,H,Dv) → (B,S,H,Dv): one fused causal
    attention.  On the card only cuDNN's fused kernel may take it (no
    S×S buffer, q·k wider than v; at MLA's 192/128 it ran 2.3 times the
    rate of the flash backend with v padded to 192, on an H100)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    args = [t.transpose(1, 2) for t in (q, k, v)]
    if q.device.type == "cuda":
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            out = F.scaled_dot_product_attention(*args, is_causal=True,
                                                 scale=scale)
    else:
        out = F.scaled_dot_product_attention(*args, is_causal=True,
                                             scale=scale)
    return out.transpose(1, 2)


def _mla_prefill_attention(lp, q_nope, q_rope, c_kv, k_rope,
                           cfg: MLAConfig):
    """K and V decompressed from the latent, then fused causal
    attention → (B,S,H,v)."""
    b, s, h, nope = q_nope.shape
    rope, vd = cfg.qk_rope_head_dim, cfg.v_head_dim
    k_nope, v = (c_kv @ lp["wkv_b"]).view(b, s, h, nope + vd).split(
        [nope, vd], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, rope)], dim=-1)
    return _causal_attention(q, k, v.contiguous(), mla_softmax_scale(cfg))


def _mla_decode_attention(lp, q_nope, q_rope, c_kv, k_rope, cache, pos,
                          cfg: MLAConfig):
    """The new latent written into ``cache`` {c_kv, k_rope} (B,Smax,·) in
    place at position ``pos`` (a (1,) int64 tensor on the device), then
    attention over the latent cache up to it with the up-projections
    absorbed: q_nope·W_UK scores against c_kv, the weights average c_kv,
    W_UV lifts that to v → (B,1,H,v).  Shapes and control flow do not
    depend on ``pos``, so a CUDA graph can replay the step."""
    b, s, h, nope = q_nope.shape
    kl, vd = cfg.kv_lora_rank, cfg.v_head_dim
    ck, cr = cache["c_kv"], cache["k_rope"]
    ck.index_copy_(1, pos, c_kv)
    cr.index_copy_(1, pos, k_rope)
    w = lp["wkv_b"].view(kl, h, nope + vd)
    # q·W_UK and P·c_kv·W_UV take bf16 operands and sum in float32, as the
    # prefill's fused kernel takes q·k and P·V; the scores and the softmax
    # are float32
    q_lat = torch.einsum("bshn,chn->bshc", q_nope, w[..., :nope])
    scores = torch.einsum(
        "bshc,btc->bsht", q_lat.to(torch.float32),
        ck.to(torch.float32)) + torch.einsum(
        "bshr,btr->bsht", q_rope.to(torch.float32), cr.to(torch.float32))
    later = torch.arange(ck.shape[1], device=ck.device) > pos
    p = torch.softmax((scores * mla_softmax_scale(cfg)).masked_fill(
        later, float("-inf")), dim=-1)
    o_lat = torch.einsum("bsht,btc->bshc", p.to(ck.dtype), ck)
    return torch.einsum("bshc,chv->bshv", o_lat, w[..., nope:])


def mla_layer_apply(lp, x, *, cfg: MLAConfig, rotation, mode: str,
                    cache: Optional[dict] = None, pos=None):
    """One block → (x', the layer's latents {c_kv, k_rope} in prefill,
    else None).  ``mode`` train | prefill | decode; ``rotation`` the
    pass's ``_mla_rotation``; in decode ``pos`` the new token's position
    (a (1,) int64 tensor)."""
    b, s, _ = x.shape
    h_in = _mla_norm(x, lp["ln1"], cfg.norm_eps)
    with obs.span("lm.mla"):
        q_nope, q_rope, c_kv, k_rope = _mla_latents(lp, h_in, cfg, rotation)
        if mode == "decode":
            out = _mla_decode_attention(lp, q_nope, q_rope, c_kv, k_rope,
                                        cache, pos, cfg)
        else:
            out = _mla_prefill_attention(lp, q_nope, q_rope, c_kv, k_rope,
                                         cfg)
        x = x + out.reshape(b, s, -1) @ lp["wo"]
    h2 = _mla_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        y = moe_lib.held_moe_ffn(h2, lp["moe"], cfg,
                                 decode=mode == "decode")
    else:
        m = lp["mlp"]
        y = swiglu(h2, m["w_gate"], m["w_up"], m["w_down"])
    new = {"c_kv": c_kv, "k_rope": k_rope} if mode == "prefill" else None
    return x + y, new


def _mla_stack(params, x, cfg: MLAConfig, body):
    """``body(x, layer params, layer index)`` over the dense layers, then
    the MoE layers (two stacks of different shapes) → (x, outputs)."""
    ys = []
    for key in ("dense_layers", "layers"):
        for lp in _unstack(params[key]):
            x, y = body(x, lp, len(ys))
            ys.append(y)
    return x, ys


def _unstack(tree) -> list:
    """A tree stacked on a leading axis → one tree a slice (views; one
    ``unbind`` a leaf)."""
    per_leaf = [torch.unbind(t) for t in leaves(tree)]
    return [unflatten(tree, list(parts)) for parts in zip(*per_leaf)]


def mla_forward_train(params, tokens, cfg: MLAConfig, mesh=None):
    """tokens (B,S) → logits (B,S,V)."""
    _refuse_mesh(cfg, mesh)
    b, s = tokens.shape
    rot = _mla_rotation(cfg, build_positions(cfg, b, s, device=tokens.device))
    x, _ = _mla_stack(params, embed_tokens(params, tokens, cfg), cfg,
                      lambda xc, lp, i: mla_layer_apply(
                          lp, xc, cfg=cfg, rotation=rot, mode="train"))
    return lm_head(params, x, cfg)


def mla_prefill(params, tokens, cfg: MLAConfig, mesh=None):
    """→ (last-position logits (B,V), the latent cache {c_kv
    (L,B,S,kv_lora), k_rope (L,B,S,rope)})."""
    _refuse_mesh(cfg, mesh)
    b, s = tokens.shape
    with obs.span("lm.prefill"):
        rot = _mla_rotation(cfg, build_positions(cfg, b, s,
                                                 device=tokens.device))
        x, ys = _mla_stack(params, embed_tokens(params, tokens, cfg), cfg,
                           lambda xc, lp, i: mla_layer_apply(
                               lp, xc, cfg=cfg, rotation=rot,
                               mode="prefill"))
        cache = {name: torch.stack([y[name] for y in ys])
                 for name in ("c_kv", "k_rope")}
        return lm_head(params, x[:, -1:], cfg)[:, 0], cache


def _mla_decode_body(params, token, pos, cache, cfg: MLAConfig):
    """One decode step of tokens (B,1) at position ``pos`` ((1,) int64 on
    their device) against the latent cache → logits (B,V).  Reads nothing
    back to the host: on the card ``_DecodeGraph`` captures and replays
    it."""
    b = token.shape[0]
    rot = _mla_rotation(cfg, pos.view(1, 1).expand(b, 1))
    per_layer = _unstack(cache)
    x, _ = _mla_stack(params, embed_tokens(params, token, cfg), cfg,
                      lambda xc, lp, i: mla_layer_apply(
                          lp, xc, cfg=cfg, rotation=rot, mode="decode",
                          cache=per_layer[i], pos=pos))
    return lm_head(params, x, cfg)[:, 0]


class _DecodeGraph:
    """``_mla_decode_body`` captured as one CUDA graph for one params tree
    and one shape: the step's ~1,000 launches become one replay, so a
    decode step costs the card's time and not the host's.  The graph owns
    a cache of its shape and static token and position inputs; a
    generation's first step copies its cache in (``load``) and carries on
    with the graph's.  The capture runs the step eagerly first (on a side
    stream, as capture asks).  It holds the params' tensors by weak
    reference: the caller's params tree stays the caller's to drop."""

    def __init__(self, params, token, pos, cache, cfg: MLAConfig):
        self.leaves = [weakref.ref(t) for t in leaves(params)]
        self.ticket = 0
        # normal tensors, so that a later generation can write them under
        # inference mode or outside it
        with torch.inference_mode(False):
            self.cache = {n: c.clone() for n, c in cache.items()}
            self.token, self.pos = token.clone(), pos.clone()
        dev = token.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.first = _mla_decode_body(params, self.token, self.pos,
                                          self.cache, cfg)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = _mla_decode_body(params, self.token, self.pos,
                                           self.cache, cfg)

    def fits(self, params) -> bool:
        now = leaves(params)
        return len(now) == len(self.leaves) and all(
            r() is t for r, t in zip(self.leaves, now))

    def load(self, cache) -> None:
        for name, c in cache.items():
            self.cache[name].copy_(c)

    def __call__(self, token, pos):
        self.token.copy_(token)
        self.pos.copy_(pos)
        self.graph.replay()
        return self.logits


class _GraphCache(dict):
    """A generation's latent cache after its first step on the card: the
    tensors of its ``_DecodeGraph``, and the ticket the graph gave this
    generation."""

    def __init__(self, graph: _DecodeGraph):
        super().__init__(graph.cache)
        self.graph, self.ticket = graph, graph.ticket


class MLADecoder:
    """``mla_decode_step`` of one config, as ``models/api.py`` hands it
    out: on the card it keeps the decode graphs it captured, one a (batch,
    cache shape, dtype, device), the last ``kept``, so that a run of
    generations of a few shapes captures each once (an ``MLADecoder``
    built afresh captures afresh, as after a change to the model's
    functions).  One generation at a time a shape: a graph's cache is the
    generation's that started last, and a step of an earlier one raises."""

    def __init__(self, cfg: MLAConfig, kept: int = 4):
        self.cfg, self.kept, self.graphs = cfg, kept, {}

    def __call__(self, params, token, cache, cache_len, mesh=None):
        return mla_decode_step(params, token, cache, cache_len, self.cfg,
                               mesh, graphs=self)

    def step(self, params, token, pos, cache):
        """→ (logits, the cache the generation carries on with)."""
        c = cache["c_kv"]
        key = (tuple(token.shape), tuple(c.shape), c.dtype, c.device)
        graph = self.graphs.get(key)
        if graph is not None and graph.fits(params):
            if getattr(cache, "graph", None) is graph:
                if cache.ticket != graph.ticket:
                    raise RuntimeError(
                        "a later generation of this shape has taken the "
                        "decode graph's cache: decode one generation at a "
                        "time a shape")
                return graph(token, pos), cache
            graph.load(cache)
            logits = graph(token, pos)
        else:
            self.graphs.pop(key, None)
            graph = self.graphs[key] = _DecodeGraph(params, token, pos,
                                                    cache, self.cfg)
            while len(self.graphs) > self.kept:
                self.graphs.pop(next(iter(self.graphs)))
            logits = graph.first
        graph.ticket += 1
        return logits, _GraphCache(graph)


def mla_decode_step(params, token, cache, cache_len, cfg: MLAConfig,
                    mesh=None, graphs: Optional[MLADecoder] = None):
    """token (B,1) against the latent cache (L,B,Smax,·), written at
    ``cache_len`` → (logits (B,V), the cache to carry on with).  With
    ``graphs`` on the card the step is a CUDA graph's replay
    (``MLADecoder.step``): the cache returned is the graph's, the given
    one copied into it at a generation's first step, and the logits are
    the graph's, overwritten by the next step.  Otherwise the step runs
    eagerly on the given cache, written in place.  Each step counts its
    held-expert pairs here: a replay runs no Python."""
    _refuse_mesh(cfg, mesh)
    max_len = cache["c_kv"].shape[2]
    if not 0 <= cache_len < max_len:
        raise ValueError(f"decode at position {cache_len} of a cache of "
                         f"{max_len}")
    with obs.span("lm.decode_step"):
        b = token.shape[0]
        moe_lib.MOE_ROWS.add(cfg.n_moe_layers * b * cfg.experts_held)
        moe_lib.MOE_TOKENS.add(cfg.n_moe_layers * b)
        pos = torch.full((1,), cache_len, dtype=torch.int64,
                         device=token.device)
        if graphs is None or token.device.type != "cuda":
            return _mla_decode_body(params, token, pos, cache, cfg), cache
        return graphs.step(params, token, pos, cache)


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int, dtype=None,
                   device=None) -> dict:
    """The latent cache: c_kv (L,B,Smax,kv_lora) and k_rope
    (L,B,Smax,rope), zeros."""
    dtype = dtype or _dtype(cfg)
    lead = (cfg.n_layers, batch, max_len)
    cache = {"c_kv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype,
                                 device=device),
             "k_rope": torch.zeros(lead + (cfg.qk_rope_head_dim,),
                                   dtype=dtype, device=device)}
    CACHE_BYTES.add(sum(c.numel() * c.element_size()
                        for c in cache.values()))
    return cache


# ---------------------------------------------------------------------------
# parameter partition specs (TP over 'model', FSDP over data axes)
# ---------------------------------------------------------------------------
def attn_pspecs(cfg: ArchConfig, dp, stacked: bool = True,
                cross: bool = False) -> dict:
    lead = (None,) if stacked else ()

    def mk(*spec):
        return P(*(lead + spec))

    p = {
        "ln1": mk(None),
        "wq": mk(dp, "model"),
        "wk": mk(dp, "model"),
        "wv": mk(dp, "model"),
        "wo": mk("model", dp),
    }
    if cross:
        p.update({"ln_x": mk(None), "xq": mk(dp, "model"),
                  "xk": mk(dp, "model"), "xv": mk(dp, "model"),
                  "xo": mk("model", dp)})
    p["ln2"] = mk(None)
    if cfg.is_moe and not cross:
        mp = moe_lib.moe_param_pspecs(cfg, dp_axes=dp if dp else ())
        p["moe"] = sh.spec_map(lambda s: P(*(lead + tuple(s))), mp)
    else:
        p["mlp"] = {"w_gate": mk(dp, "model"), "w_up": mk(dp, "model"),
                    "w_down": mk("model", dp)}
    return p


def decoder_param_pspecs(cfg: ArchConfig, mesh) -> dict:
    dp = dp_axes_of(mesh) or None
    emb = ({"hash_tables": P(None, None, "model")}
           if cfg.embedding == "bbit_hash"
           else {"table": P(None, "model")})
    return {
        "embed": emb,
        "final_norm": P(None),
        "lm_head": P(dp, "model"),
        "layers": attn_pspecs(cfg, dp, stacked=cfg.scan_layers or True),
    }
