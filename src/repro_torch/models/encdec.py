"""Encoder-decoder stack (seamless-m4t): a speech encoder over stub frame
embeddings and a text decoder with cross-attention (counterpart of
``repro/models/encdec.py``).

The encoder reads precomputed frames (B, frames, d_model); positions
are sinusoidal and added (rope_variant='none').  Decode runs the decoder
against its self-attention KV cache (written in place) and the cross
K/V that prefill computed once.

On a mesh the stacks run as ``models/transformer.py`` runs them
(``mesh`` threads through; ``encdec_param_pspecs`` lays out the params).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.shardings import P
from repro_torch.models.layers import ParamInit, rmsnorm
from repro_torch.models.transformer import (_dtype, attn_apply,
                                            attn_pspecs, build_positions,
                                            checkpointed, dp_axes_of,
                                            maybe_shard,
                                            cross_attn_apply, embed_tokens,
                                            encode_cross_kv, ffn_apply,
                                            init_attn_params,
                                            init_embed_params, lm_head)
from repro_torch.tree import tree_map, tree_stack


def sinusoidal(seq: int, d: int, offset=0, device=None) -> torch.Tensor:
    pos = (torch.arange(seq, dtype=torch.float32, device=device)
           + float(offset))[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / 10000.0 ** (dim / d)
    out = torch.zeros((seq, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang[:, : d // 2])
    return out


def init_encdec_params(cfg: ArchConfig, init: ParamInit) -> dict:
    dtype = _dtype(cfg)
    params = init_embed_params(cfg, init, dtype)
    params["enc_layers"] = init_attn_params(cfg, init, dtype,
                                            lead=(cfg.enc_layers,))
    params["dec_layers"] = init_attn_params(cfg, init, dtype, cross=True,
                                            lead=(cfg.n_layers,))
    params["enc_norm"] = init.full((cfg.d_model,), 1.0, dtype)
    return params


def _layers(cfg, body, x, stacked, n, ys=False):
    """``body`` over ``n`` stacked layers (remat-wrapped when the
    reference wraps it) → (x, outputs stacked if ``ys``)."""
    fn = checkpointed(body) if cfg.remat else body
    outs = []
    for i in range(n):
        x, y = fn(x, tree_map(lambda p: p[i], stacked))
        outs.append(y)
    return x, tree_stack(outs, torch.stack) if ys else None


def encode(params, frames: torch.Tensor, cfg: ArchConfig,
           mesh=None) -> torch.Tensor:
    """frames (B, F, d) stub embeddings → encoder output (B, F, d)."""
    b, f, d = frames.shape
    dtype = _dtype(cfg)
    x = frames.to(dtype) + sinusoidal(f, d, device=frames.device).to(
        dtype)[None]
    x = maybe_shard(x, mesh, dp_axes_of(mesh), None, None)
    positions = build_positions(cfg, b, f, device=frames.device)

    def body(xc, lp):
        xc, _ = attn_apply(lp, xc, cfg=cfg, mesh=mesh, positions=positions,
                           mode="train", causal=False)
        return ffn_apply(lp, xc, cfg, mesh), None

    x, _ = _layers(cfg, body, x, params["enc_layers"], cfg.enc_layers)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(lp, x, enc_kv, *, cfg, mesh=None, positions, mode,
               cache=None, cache_len=None):
    x, new_kv = attn_apply(lp, x, cfg=cfg, mesh=mesh, positions=positions,
                           mode=mode, cache=cache, cache_len=cache_len)
    x = cross_attn_apply(lp, x, enc_kv, cfg, mesh)
    return ffn_apply(lp, x, cfg, mesh), new_kv


def _embed_dec(params, tokens, cfg, mesh=None, offset=0):
    x = embed_tokens(params, tokens, cfg, mesh)
    pe = sinusoidal(tokens.shape[1], cfg.d_model, offset=offset,
                    device=tokens.device)
    return x + pe.to(x.dtype)[None]


def forward_train(params, tokens, frames, cfg: ArchConfig, mesh=None):
    """Teacher-forced decoder logits (B, S, V)."""
    enc_out = encode(params, frames, cfg, mesh)
    b, s = tokens.shape
    x = _embed_dec(params, tokens, cfg, mesh)
    positions = build_positions(cfg, b, s, device=tokens.device)

    def body(xc, lp):
        enc_kv = encode_cross_kv(lp, enc_out, cfg, mesh)
        xc, _ = _dec_layer(lp, xc, enc_kv, cfg=cfg, mesh=mesh,
                           positions=positions, mode="train")
        return xc, None

    x, _ = _layers(cfg, body, x, params["dec_layers"], cfg.n_layers)
    return lm_head(params, x, cfg, mesh)


def prefill(params, tokens, frames, cfg: ArchConfig, mesh=None):
    """→ (last logits, cache {self {k, v}, cross {k, v}})."""
    enc_out = encode(params, frames, cfg, mesh)
    b, s = tokens.shape
    x = _embed_dec(params, tokens, cfg, mesh)
    positions = build_positions(cfg, b, s, device=tokens.device)

    def body(xc, lp):
        enc_kv = encode_cross_kv(lp, enc_out, cfg, mesh)
        xc, kv = _dec_layer(lp, xc, enc_kv, cfg=cfg, mesh=mesh,
                            positions=positions, mode="prefill")
        return xc, (kv, enc_kv)

    x, (self_kv, cross_kv) = _layers(cfg, body, x, params["dec_layers"],
                                     cfg.n_layers, ys=True)
    logits = lm_head(params, x[:, -1:], cfg, mesh)[:, 0]
    return logits, {"self": self_kv, "cross": cross_kv}


def decode_step(params, token, cache, cache_len, cfg: ArchConfig,
                mesh=None):
    """One token; the self-attention cache is written in place."""
    b = token.shape[0]
    x = _embed_dec(params, token, cfg, mesh, offset=cache_len)
    positions = build_positions(cfg, b, 1, offset=cache_len,
                                device=token.device)
    for i in range(cfg.n_layers):
        lp, self_kv, cross_kv = tree_map(
            lambda p: p[i],
            (params["dec_layers"], cache["self"], cache["cross"]))
        x, _ = _dec_layer(lp, x, cross_kv, cfg=cfg, mesh=mesh,
                          positions=positions, mode="decode",
                          cache=self_kv, cache_len=cache_len)
    return lm_head(params, x, cfg, mesh)[:, 0], cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    dtype = _dtype(cfg)
    self_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                  cfg.head_dim)
    cross_shape = (cfg.n_layers, batch, cfg.frontend_len, cfg.n_kv_heads,
                   cfg.head_dim)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"self": {"k": zeros(self_shape), "v": zeros(self_shape)},
            "cross": {"k": zeros(cross_shape), "v": zeros(cross_shape)}}


def encdec_param_pspecs(cfg: ArchConfig, mesh) -> dict:
    dp = dp_axes_of(mesh) or None
    return {
        "embed": ({"hash_tables": P(None, None, "model")}
                  if cfg.embedding == "bbit_hash"
                  else {"table": P(None, "model")}),
        "final_norm": P(None),
        "enc_norm": P(None),
        "lm_head": P(dp, "model"),
        "enc_layers": attn_pspecs(cfg, dp, stacked=True),
        "dec_layers": attn_pspecs(cfg, dp, stacked=True, cross=True),
    }
