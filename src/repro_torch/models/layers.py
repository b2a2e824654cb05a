"""Shared transformer building blocks (counterpart of
``repro/models/layers.py``), plain torch.

Conventions, the reference's:
  * activations (B, S, D); math in the config's dtype (bfloat16 or
    float32), norms, softmax and accumulation in float32;
  * attention is blockwise (streaming softmax): O(S·chunk) live scores,
    kv chunks a causal q chunk cannot see skipped, no S×S buffer.  The
    reference computes it outside any Pallas kernel, and so does the
    port: these are torch ops, the chunking, masks and float32
    accumulation the reference's, so the decode path's ``kv_valid_len``
    masking means the same thing in both packages.

Params are plain tensors drawn by ``ParamInit`` from a seeded
``torch.Generator`` with the reference's shapes, dtypes and scales (not
its values: JAX's PRNG is not torch's; ``models/api.py::params_from_jax``
carries the reference's own values over).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.universal_hash import MASK32, fmix32, mul32


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ParamInit:
    """Draws params: N(0, 1)·scale in float32 on the generator's device,
    cast to the leaf's dtype and moved to ``device``.  On the ``meta``
    device (no generator) it only shapes them: ``params_from_jax`` checks
    the reference's tree against that."""
    generator: Optional[torch.Generator]
    device: torch.device

    def normal(self, shape, scale: float, dtype) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
        gen = self.generator
        draw = torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32) * scale
        return draw.to(device=self.device, dtype=dtype)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


# ---------------------------------------------------------------------------
# Norms / MLP
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# ---------------------------------------------------------------------------
# RoPE family: standard / partial (chatglm) / M-RoPE (qwen2-vl)
# ---------------------------------------------------------------------------
def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float, inv: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """positions (..., S) → angles (..., S, dim/2) float32, at the
    frequencies ``inv`` (default θ^(−2i/dim)).  Rows that a broadcast
    repeats (stride 0, as ``build_positions`` gives) are computed once
    and broadcast again."""
    while positions.dim() > 1 and positions.shape[0] > 1 and \
            positions.stride(0) == 0:
        positions = positions[:1]
    if inv is None:
        exps = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=positions.device) / dim
        inv = 1.0 / theta ** exps
    return positions.to(torch.float32)[..., None] * inv


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's temperature 0.1·mscale·ln(factor) + 1 (1 at factor ≤ 1)."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def _yarn_correction_dim(rotations: float, dim: int, theta: float,
                         orig: int) -> float:
    """The rotary dim whose pair turns ``rotations`` times over ``orig``
    positions."""
    return dim * math.log(orig / (rotations * 2 * math.pi)) / (
        2 * math.log(theta))


def yarn_inv_freq(dim: int, theta: float, factor: float, orig: int,
                  beta_fast: float, beta_slow: float,
                  device=None) -> torch.Tensor:
    """YaRN's frequencies, float32 (dim/2,): pairs below the dim that
    turns ``beta_fast`` times over the trained ``orig`` positions keep
    θ^(−2i/dim), pairs past the one that turns ``beta_slow`` times are
    divided by ``factor``, with a linear ramp between (DeepSeek-V3's
    ``DeepseekV3YarnRotaryEmbedding``)."""
    low = max(math.floor(_yarn_correction_dim(beta_fast, dim, theta, orig)),
              0)
    high = min(math.ceil(_yarn_correction_dim(beta_slow, dim, theta, orig)),
               dim - 1)
    if low == high:
        high += 0.001
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)
    extra, inter = 1.0 / base, 1.0 / (factor * base)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1.0 - keep) + extra * keep


def _apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated pairwise by angles (B, S, D/2)."""
    return apply_rotation(x, (torch.cos(angles)[..., None, :],
                              torch.sin(angles)[..., None, :]))


def yarn_rotation(positions: torch.Tensor, dim: int, theta: float,
                  yarn: Tuple[float, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """YaRN's rotation at ``positions`` (B,S): (cos, sin) (B,S,1,dim/2)
    float32 of the angles at ``yarn_inv_freq``'s frequencies, each times
    m = yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim),
    the factor the rotated vectors take, for ``yarn`` = (factor, original
    positions, beta_fast, beta_slow, mscale, mscale_all_dim).  Computed
    once a pass and given to every layer's ``apply_rotation``."""
    factor, orig, fast, slow, mscale, mscale_all = yarn
    inv = yarn_inv_freq(dim, theta, factor, int(orig), fast, slow,
                        device=positions.device)
    ang = _rope_angles(positions, dim, theta, inv)[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    m = yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all)
    return (cos, sin) if m == 1.0 else (cos * m, sin * m)


def apply_rotation(x: torch.Tensor,
                   rotation: Tuple[torch.Tensor, torch.Tensor]
                   ) -> torch.Tensor:
    """x (B,S,H,D) rotated pairwise, (i, i + D/2), by ``yarn_rotation``'s
    (cos, sin), in float32."""
    cos, sin = rotation
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               *, variant: str = "standard", theta: float = 10000.0,
               mrope_sections: Tuple[int, ...] = (16, 24, 24)
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,D), k (B,S,KV,D); positions (B,S) or (B,S,3) for mrope."""
    d = q.shape[-1]
    if variant == "none":
        return q, k
    if variant == "partial":  # chatglm3: rotary on the first half dims
        dr = d // 2
        ang = _rope_angles(positions, dr, theta)
        q = torch.cat([_apply_rotary(q[..., :dr], ang), q[..., dr:]], dim=-1)
        k = torch.cat([_apply_rotary(k[..., :dr], ang), k[..., dr:]], dim=-1)
        return q, k
    if variant == "mrope":   # qwen2-vl: 3 position streams over sections
        # positions (B, S, 3): temporal / height / width ids
        half = d // 2
        assert sum(mrope_sections) == half, (mrope_sections, half)
        parts, lo = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(_rope_angles(positions[..., i], d,
                                      theta)[..., lo:lo + sec])
            lo += sec
        ang_full = torch.cat(parts, dim=-1)
        return _apply_rotary(q, ang_full), _apply_rotary(k, ang_full)
    # standard
    ang = _rope_angles(positions, d, theta)
    return _apply_rotary(q, ang), _apply_rotary(k, ang)


# ---------------------------------------------------------------------------
# Blockwise (streaming-softmax) attention with GQA
# ---------------------------------------------------------------------------
def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,H,D), k (B,Skv,KV,D) → scores (B,H,Sq,Skv) float32."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32))
    return s.reshape(b, h, sq, k.shape[1]) / math.sqrt(d)


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B,H,Sq,Skv) float32, v (B,Skv,KV,D) → out (B,Sq,H,D) float32."""
    b, h, sq, skv = p.shape
    kv = v.shape[2]
    pg = p.reshape(b, kv, h // kv, sq, skv)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg, v.to(torch.float32))
    return o.reshape(b, sq, h, v.shape[-1])


def _attend_block(qc, kc, vc, m, l, acc, q_pos, kv_pos, causal,
                  kv_valid_len):
    """One (q-block × kv-block) online-softmax update.

    qc (B,qc,H,D); kc/vc (B,kc,KV,D); m/l (B,H,qc); acc (B,qc,H,D) f32.
    Masked scores are -inf before the exp, and a row with no key yet
    keeps m = -inf, so ``m_safe`` and ``corr`` hold the exps finite.
    """
    s = _gqa_scores(qc, kc)                   # (B,H,qc,kc) float32
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=s.device)
    if causal:
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    if kv_valid_len is not None:
        mask = mask & (kv_pos < kv_valid_len)[None, :]
    s = torch.where(mask, s, -math.inf)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr.transpose(1, 2)[..., None] + _gqa_values(p, vc)
    return m_new, l, acc


def _init_block(b, h, n, d, device):
    return (torch.full((b, h, n), -math.inf, dtype=torch.float32,
                       device=device),
            torch.zeros((b, h, n), dtype=torch.float32, device=device),
            torch.zeros((b, n, h, d), dtype=torch.float32, device=device))


def _finish_block(l, acc, dtype):
    denom = torch.clamp_min(l, 1e-20).transpose(1, 2)[..., None]
    return (acc / denom).to(dtype)


def blockwise_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid_len=None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    impl: str = "loop",
) -> torch.Tensor:
    """Streaming-softmax attention; q (B,Sq,H,D), k/v (B,Skv,KV,D).

    ``q_offset``: absolute position of q[0] (decode/prefill continuation).
    ``kv_valid_len``: an int or 0-d tensor; keys at index ≥ it are masked
    (the cache).  ``impl``:
      * 'loop' — kv chunks that a causal q chunk cannot see are skipped;
      * 'scan' — q and kv padded to whole chunks, every kv chunk visited
        with the padded keys masked through ``kv_valid_len`` (the
        reference's ``lax.scan`` form: one block's float32 buffers at a
        time).
    """
    if impl == "scan":
        return _blockwise_attention_scan(
            q, k, v, causal=causal, q_offset=q_offset,
            kv_valid_len=kv_valid_len, q_chunk=q_chunk, kv_chunk=kv_chunk)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    n_q = (sq + q_chunk - 1) // q_chunk
    n_kv = (skv + kv_chunk - 1) // kv_chunk
    dev = q.device

    outs = []
    for qi in range(n_q):
        q_lo = qi * q_chunk
        q_hi = min(q_lo + q_chunk, sq)
        q_pos = q_offset + q_lo + torch.arange(q_hi - q_lo, device=dev)
        m, l, acc = _init_block(b, h, q_hi - q_lo, d, dev)
        if causal:   # the last kv chunk this q chunk can see
            max_kv = min(skv, q_offset + q_hi)
            n_kv_here = (max_kv + kv_chunk - 1) // kv_chunk
        else:
            n_kv_here = n_kv
        for ki in range(n_kv_here):
            k_lo = ki * kv_chunk
            k_hi = min(k_lo + kv_chunk, skv)
            kv_pos = k_lo + torch.arange(k_hi - k_lo, device=dev)
            m, l, acc = _attend_block(
                q[:, q_lo:q_hi], k[:, k_lo:k_hi], v[:, k_lo:k_hi], m, l,
                acc, q_pos, kv_pos, causal, kv_valid_len)
        outs.append(_finish_block(l, acc, q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def _blockwise_attention_scan(q, k, v, *, causal, q_offset, kv_valid_len,
                              q_chunk, kv_chunk):
    """The 'scan' impl: padded chunks, every pair visited."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    qp = F.pad(q, (0, 0, 0, 0, 0, (-sq) % q_chunk))
    kp = F.pad(k, (0, 0, 0, 0, 0, (-skv) % kv_chunk))
    vp = F.pad(v, (0, 0, 0, 0, 0, (-skv) % kv_chunk))
    nq = qp.shape[1] // q_chunk
    nkv = kp.shape[1] // kv_chunk
    # padded keys must never win: mask them via kv_valid_len
    valid = skv if kv_valid_len is None else kv_valid_len
    dev = q.device
    outs = []
    for qi in range(nq):
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        qc = qp[:, qi * q_chunk:(qi + 1) * q_chunk]
        m, l, acc = _init_block(b, h, q_chunk, d, dev)
        for ki in range(nkv):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kv_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            m, l, acc = _attend_block(qc, kp[:, sl], vp[:, sl], m, l, acc,
                                      q_pos, kv_pos, causal, valid)
        outs.append(_finish_block(l, acc, q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


# ---------------------------------------------------------------------------
# Embeddings: dense and b-bit-hashed (the paper's technique, adapted)
# ---------------------------------------------------------------------------
def hashed_embed_params(vocab: int, d: int, hash_k: int, hash_b: int,
                        init: ParamInit, dtype) -> dict:
    """k tables of 2^b rows replace the (vocab, d) table — the paper's
    n·b·k storage argument applied to embedding matrices."""
    del vocab
    return {"hash_tables": init.normal((hash_k, 1 << hash_b, d), 0.02,
                                       dtype)}


def hashed_embed_codes(tokens: torch.Tensor, hash_k: int,
                       hash_b: int) -> torch.Tensor:
    """tokens (...) int → codes (..., k) int64: code_j(t) = the low b bits
    of fmix32(a_j·t + c_j mod 2^32), with a_j and c_j derived from j (the
    reference's seedless tables).  uint32 words are held in int64 in
    [0, 2^32) (``core/universal_hash.py``), so the codes equal the
    reference's bit for bit."""
    j = torch.arange(hash_k, dtype=torch.int64, device=tokens.device)
    a = ((mul32(j, 0x9E3779B1) + 0x85EBCA6B) & MASK32) | 1
    c = fmix32((j + 0x27D4EB2F) & MASK32)
    t = tokens.to(torch.int64)[..., None] & MASK32
    return fmix32((mul32(t, a) + c) & MASK32) & ((1 << hash_b) - 1)


def hashed_embed_lookup(params: dict, tokens: torch.Tensor,
                        hash_k: int, hash_b: int) -> torch.Tensor:
    """tokens (B,S) int → (B,S,D): Σ_j tables[j, code_j(t)] / √k.  The sum
    runs in float32 and is rounded to the tables' dtype before the
    division, as jnp's sum of a bfloat16 array does."""
    codes = hashed_embed_codes(tokens, hash_k, hash_b)      # (B,S,k)
    tables = params["hash_tables"]                          # (k, 2^b, D)
    j = torch.arange(hash_k, device=tokens.device)
    emb = torch.sum(tables[j, codes], dim=-2, dtype=torch.float32)
    emb = emb.to(tables.dtype).to(torch.float32)
    return (emb / math.sqrt(hash_k)).to(tables.dtype)
