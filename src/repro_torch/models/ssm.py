"""Mamba2 (SSD) block, chunked state-space duality (counterpart of
``repro/models/ssm.py``), plain torch.

Per head h with state size N, input x_t (head_dim P), gate dt_t > 0 and
decay A < 0:

    h_t = exp(dt_t·A) h_{t-1} + dt_t·B_t x_tᵀ       (N × P matrix state)
    y_t = C_tᵀ h_t + D x_t

computed chunk-parallel: the intra-chunk quadratic term and the
inter-chunk state recurrence (a loop over chunks).  ``n_groups = 1``: B
and C are shared across heads.  ``mamba2_decode_step`` carries (matrix
state, conv buffer), O(1) a token.  The masked triangle of ``_segsum``
is -inf before the exp, so the backward pass meets no inf·0.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2_params(cfg: ArchConfig, init, dtype,
                       lead: tuple = ()) -> dict:
    d = cfg.d_model
    d_in, nh, n = ssm_dims(cfg)
    cw = cfg.ssm_conv_width
    proj_dim = 2 * d_in + 2 * n + nh      # z, x, B, C, dt
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32))
    return {
        "in_proj": init.normal(lead + (d, proj_dim), d ** -0.5, dtype),
        "conv_w": init.normal(lead + (cw, d_in + 2 * n), 0.1, dtype),
        "conv_b": init.full(lead + (d_in + 2 * n,), 0.0, dtype),
        "a_log": a_log.to(init.device).expand(lead + (nh,)).clone(),
        "dt_bias": init.full(lead + (nh,), 0.0, torch.float32),
        "d_skip": init.full(lead + (nh,), 1.0, torch.float32),
        "norm_scale": init.full(lead + (d_in,), 1.0, dtype),
        "out_proj": init.normal(lead + (d_in, d), d_in ** -0.5, dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) → (..., L, L) lower-tri segment sums Σ_{s<i≤t} x_i."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H) float32 (softplused)
    a: torch.Tensor,     # (H,) float32 negative decay
    b_in: torch.Tensor,  # (B, S, N)
    c_in: torch.Tensor,  # (B, S, N)
    h0: torch.Tensor,    # (B, H, N, P) initial state
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (y (B,S,H,P) float32, final state (B,H,N,P) float32)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).to(torch.float32)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_in.reshape(bsz, nc, chunk, n).to(torch.float32)
    cc = c_in.reshape(bsz, nc, chunk, n).to(torch.float32)

    da = dtc * a[None, None, None, :]                # (B,nc,l,H)
    da_t = da.movedim(-1, -2)                        # (B,nc,H,l)
    # intra-chunk (diagonal block) term
    ell = torch.exp(_segsum(da_t))                   # (B,nc,H,l,l)
    y_diag = torch.einsum("bzln,bzmn,bzhlm,bzmhp,bzmh->bzlhp",
                          cc, bc, ell, xc, dtc)
    # per-chunk outgoing state
    da_cum = torch.cumsum(da_t, dim=-1)              # (B,nc,H,l)
    decay_out = torch.exp(da_cum[..., -1:] - da_cum)
    states = torch.einsum("bzln,bzhl,bzlhp,bzlh->bzhnp",
                          bc, decay_out, xc, dtc)    # (B,nc,H,N,P)
    chunk_decay = torch.exp(da_cum[..., -1])         # (B,nc,H)

    # inter-chunk recurrence: the state entering each chunk
    carry = h0.to(torch.float32)
    h_in = []
    for z in range(nc):
        h_in.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    h_in = torch.stack(h_in, dim=1)                  # (B,nc,H,N,P)

    # inter-chunk (off-diagonal) contribution
    state_decay_in = torch.exp(da_cum)               # (B,nc,H,l)
    y_off = torch.einsum("bzln,bzhnp,bzhl->bzlhp", cc, h_in,
                         state_decay_in)
    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y, carry


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor = None):
    """Depthwise causal conv; x (B,S,C), w (W,C) → (y, new_state), the
    state (B, W-1, C) carrying the last W-1 inputs for decode."""
    width = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, width - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    out = x_pad[:, 0:x.shape[1]] * w[0][None, None]
    for i in range(1, width):
        out = out + x_pad[:, i:i + x.shape[1]] * w[i][None, None]
    return out + b[None, None], x_pad[:, -(width - 1):]


def mamba2_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   h0=None, conv0=None, chunk: int = 128):
    """x (B,S,D) → (y (B,S,D), (state, conv_state)) — train & prefill."""
    bsz, s, _ = x.shape
    d_in, nh, n = ssm_dims(cfg)
    proj = x @ params["in_proj"]                      # (B,S,proj)
    z, xin, b_raw, c_raw, dt_raw = torch.split(
        proj, [d_in, d_in, n, n, nh], dim=-1)
    conv_in = torch.cat([xin, b_raw, c_raw], dim=-1)
    if conv0 is None:
        conv0 = torch.zeros((bsz, cfg.ssm_conv_width - 1, d_in + 2 * n),
                            dtype=x.dtype, device=x.device)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"],
                                        params["conv_b"], conv0)
    conv_out = F.silu(conv_out)
    xs, bs, cs = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"][None, None])
    a = -torch.exp(params["a_log"])
    if h0 is None:
        h0 = torch.zeros((bsz, nh, n, cfg.ssm_head_dim),
                         dtype=torch.float32, device=x.device)
    xh = xs.reshape(bsz, s, nh, cfg.ssm_head_dim)
    y, h_final = ssd_chunked(xh, dt, a, bs, cs, h0, chunk=chunk)
    y = y + params["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(bsz, s, d_in).to(x.dtype)
    # gated RMSNorm (Mamba2's norm before out_proj)
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    y = (yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
         * params["norm_scale"].to(torch.float32)).to(x.dtype)
    return y @ params["out_proj"], (h_final, conv_state)


def mamba2_decode_step(params: dict, x1: torch.Tensor, cfg: ArchConfig,
                       state):
    """Single-token step; x1 (B,1,D); state = (h, conv_state)."""
    h0, conv0 = state
    return mamba2_forward(params, x1, cfg, h0=h0, conv0=conv0, chunk=1)
