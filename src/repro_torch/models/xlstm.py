"""xLSTM blocks: chunk-parallel mLSTM and recurrent sLSTM (counterpart of
``repro/models/xlstm.py``, arXiv:2405.04517), plain torch.

mLSTM (matrix memory, exponential gating) runs chunkwise like SSD: the
(q·k)⊙D·v products over all chunks at once, the small (C, n, m) state
carried from chunk to chunk.  Stabilized gating, per head, in log space:

    log f = logsigmoid(f̃),  F_t = Σ_{u≤t} log f_u  (within a chunk)
    m_t   = max(m_in + F_t, max_{s≤t}(F_t − F_s + ĩ_s))
    C̃_t  = e^{m_in+F_t−m_t} C̃_in + Σ_{s≤t} e^{F_t−F_s+ĩ_s−m_t} v_s k_sᵀ
    h_t   = (C̃_t q_t) / max(|ñ_t·q_t|, e^{−m_t})

Padded steps take ĩ = −1e30 and f̃ = 30 (log f ≈ 0), so they add nothing
and keep the state; the masked triangle is −inf before the exp.  sLSTM
(scalar memory, recurrent R h_{t−1} gate inputs) is a loop over time.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


def xlstm_dims(cfg: ArchConfig) -> Tuple[int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.n_heads


def _rms_out(y: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    yf = y.to(torch.float32)
    return (yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True)
                             + 1e-6) * scale.to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm_params(cfg: ArchConfig, init, dtype, lead: tuple = ()) -> dict:
    d = cfg.d_model
    d_in, p = xlstm_dims(cfg)
    h = cfg.n_heads
    bias = torch.cat([torch.zeros(h), 3.0 * torch.ones(h)])
    return {
        "up_proj": init.normal(lead + (d, 2 * d_in), d ** -0.5, dtype),
        "wq": init.normal(lead + (h, p, p), p ** -0.5, dtype),
        "wk": init.normal(lead + (h, p, p), p ** -0.5, dtype),
        "wv": init.normal(lead + (h, p, p), p ** -0.5, dtype),
        "w_gates": init.normal(lead + (d_in, 2 * h), 0.01, torch.float32),
        "gate_bias": bias.to(init.device).expand(lead + (2 * h,)).clone(),
        "out_norm": init.full(lead + (d_in,), 1.0, dtype),
        "down_proj": init.normal(lead + (d_in, d), d_in ** -0.5, dtype),
    }


def _mlstm_core(q, k, v, i_raw, f_raw, state, chunk: int):
    """q/k/v (B,S,H,P); i_raw/f_raw (B,S,H) float32; state (C (B,H,P,P),
    n (B,H,P), m (B,H)) or None → (h (B,S,H,P) float32, new state)."""
    bsz, s, h, p = q.shape
    dev = q.device
    if state is None:
        state = (torch.zeros((bsz, h, p, p), device=dev),
                 torch.zeros((bsz, h, p), device=dev),
                 torch.full((bsz, h), -1e30, device=dev))
    c0, n0, m0 = state
    pad = (-s) % chunk
    if pad:
        def z(x, fill=0.0):
            widths = (0, 0) * (x.dim() - 2) + (0, pad)
            return F.pad(x, widths, value=fill)
        q, k, v = z(q), z(k), z(v)
        i_raw = z(i_raw, -1e30)   # padded steps contribute nothing
        f_raw = z(f_raw, 30.0)    # log f ≈ 0 → state preserved
    nc = (s + pad) // chunk
    l = chunk
    qc = q.reshape(bsz, nc, l, h, p).to(torch.float32)
    kc = k.reshape(bsz, nc, l, h, p).to(torch.float32)
    vc = v.reshape(bsz, nc, l, h, p).to(torch.float32)
    ic = i_raw.reshape(bsz, nc, l, h)
    fc = f_raw.reshape(bsz, nc, l, h)

    logf = F.logsigmoid(fc)                           # (B,nc,l,H)
    Fc = torch.cumsum(logf, dim=2)                    # F_t
    # pairwise log decay (t ≥ s): F_t − F_s + ĩ_s
    logD = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] \
        + ic[:, :, None, :, :]                        # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dev))
    logD = torch.where(tri[None, None, :, :, None], logD, -math.inf)
    m_loc = torch.amax(logD, dim=3)                   # (B,nc,t,H)

    # chunk-end operator (for the state loop): decay e^{F_l}, and the
    # end-state contributions under the local stabilizer m_end
    log_end = Fc[:, :, -1:, :] - Fc + ic              # (B,nc,l,H)
    m_end = torch.amax(log_end, dim=2)                # (B,nc,H)
    w_end = torch.exp(log_end - m_end[:, :, None, :])
    c_add = torch.einsum("bzlh,bzlhp,bzlhr->bzhpr", w_end, vc, kc)
    n_add = torch.einsum("bzlh,bzlhp->bzhp", w_end, kc)
    a_log = Fc[:, :, -1, :]                           # (B,nc,H) log decay

    c, n, m = c0, n0, m0
    c_in, n_in, m_in = [], [], []
    for zi in range(nc):                              # emit incoming
        c_in.append(c)
        n_in.append(n)
        m_in.append(m)
        m_new = torch.maximum(m + a_log[:, zi], m_end[:, zi])
        sc_old = torch.exp(m + a_log[:, zi] - m_new)
        sc_add = torch.exp(m_end[:, zi] - m_new)
        c = c * sc_old[..., None, None] + c_add[:, zi] * sc_add[..., None,
                                                                 None]
        n = n * sc_old[..., None] + n_add[:, zi] * sc_add[..., None]
        m = m_new
    c_in = torch.stack(c_in, dim=1)                   # (B,nc,H,P,P)
    n_in = torch.stack(n_in, dim=1)
    m_in = torch.stack(m_in, dim=1)                   # (B,nc,H)

    # final stabilizer per position
    m_t = torch.maximum(m_in[:, :, None, :] + Fc, m_loc)   # (B,nc,t,H)
    w_intra = torch.exp(logD - m_t[:, :, :, None, :])      # (B,nc,t,s,H)
    scores = torch.einsum("bzthp,bzshp->bztsh", qc, kc)
    num_intra = torch.einsum("bztsh,bzshp->bzthp", w_intra * scores, vc)
    den_intra = torch.einsum("bztsh,bzshp,bzthp->bzth", w_intra, kc, qc)
    g_in = torch.exp(m_in[:, :, None, :] + Fc - m_t)       # (B,nc,t,H)
    num_inter = torch.einsum("bzhpr,bzthr->bzthp", c_in, qc) \
        * g_in[..., None]
    den_inter = torch.einsum("bzhp,bzthp->bzth", n_in, qc) * g_in
    num = num_intra + num_inter
    den = torch.maximum(torch.abs(den_intra + den_inter), torch.exp(-m_t))
    hout = (num / den[..., None]).reshape(bsz, nc * l, h, p)[:, :s]
    return hout, (c, n, m)


def mlstm_forward(params, x, cfg: ArchConfig, *, state=None,
                  chunk: int = 128):
    """x (B,S,D) → (y (B,S,D), state)."""
    bsz, s, _ = x.shape
    d_in, p = xlstm_dims(cfg)
    h = cfg.n_heads
    up = x @ params["up_proj"]
    xm, z = torch.chunk(up, 2, dim=-1)                # (B,S,d_in) each
    xh = xm.reshape(bsz, s, h, p)
    q = torch.einsum("bshp,hpr->bshr", xh, params["wq"])
    # √p in float32, rounded to the activations' dtype (the reference's)
    root_p = float(torch.tensor(math.sqrt(p), dtype=torch.float32).to(
        x.dtype))
    k = torch.einsum("bshp,hpr->bshr", xh, params["wk"]) / root_p
    v = torch.einsum("bshp,hpr->bshr", xh, params["wv"])
    gates = xm.to(torch.float32) @ params["w_gates"] \
        + params["gate_bias"][None, None]
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)      # (B,S,H)
    hout, new_state = _mlstm_core(q, k, v, i_raw, f_raw, state, chunk)
    y = hout.reshape(bsz, s, d_in).to(x.dtype) * F.silu(z)
    return _rms_out(y, params["out_norm"], x.dtype) @ params["down_proj"], \
        new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm_params(cfg: ArchConfig, init, dtype, lead: tuple = ()) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    p = d // h
    return {
        "w_in": init.normal(lead + (d, 4 * d), d ** -0.5, dtype),
        "r": init.normal(lead + (h, p, 4 * p), p ** -0.5, dtype),
        "bias": init.full(lead + (4 * d,), 0.0, torch.float32),
        "out_norm": init.full(lead + (d,), 1.0, dtype),
        "out_proj": init.normal(lead + (d, d), d ** -0.5, dtype),
    }


def slstm_forward(params, x, cfg: ArchConfig, *, state=None):
    """x (B,S,D) → (y, state); state = (c, n, h, m), each (B, H, D/H)."""
    bsz, s, d = x.shape
    nh = cfg.n_heads
    p = d // nh
    if state is None:
        zeros = torch.zeros((bsz, nh, p), device=x.device)
        state = (zeros, zeros + 1.0, zeros, zeros - 1e30)
    pre = (x @ params["w_in"]).to(torch.float32) \
        + params["bias"][None, None]                  # (B,S,4D)
    pre = pre.reshape(bsz, s, nh, 4 * p)
    r = params["r"].to(torch.float32)
    c, n, hprev, m = state
    hs = []
    for t in range(s):
        rec = torch.einsum("bhp,hpr->bhr", hprev, r)  # (B,H,4P)
        zi, ii, fi, oi = torch.chunk(pre[:, t] + rec, 4, dim=-1)
        zg = torch.tanh(zi)
        og = torch.sigmoid(oi)
        # exponential gating with a stabilizer (per head and unit)
        f_l = F.logsigmoid(fi)
        m_new = torch.maximum(f_l + m, ii)
        ig = torch.exp(ii - m_new)
        fg = torch.exp(f_l + m - m_new)
        c = fg * c + ig * zg
        n = fg * n + ig
        hprev = og * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(hprev)
    y = torch.stack(hs, dim=1).reshape(bsz, s, d).to(x.dtype)
    return _rms_out(y, params["out_norm"], x.dtype) @ params["out_proj"], \
        (c, n, hprev, m)
