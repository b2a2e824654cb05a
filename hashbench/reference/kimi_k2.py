"""A plain float32 forward pass of Kimi-K2-Instruct, one card's share.

The equations are DeepSeek-V3's (arXiv:2412.19437 §2.1) with the values
of https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json:
RMSNorm; multi-head latent attention (queries through a rank-q_lora
down-projection, its norm and an up-projection; keys and values from a
normed rank-kv_lora latent, plus one rotary key shared by all heads);
YaRN rotary frequencies and its mscale² in the softmax scale; the first
layers dense SwiGLU, the rest MoE with sigmoid scores, a score-correction
bias that picks and does not weigh, the top-k scores normalised to sum 1
and scaled, and one shared expert.  No kernel, no cache, no batching
tricks: every position of every sequence runs the whole model, in
float32, with TF32 off.  Attention runs in blocks of queries and heads so
that a long sequence fits; that changes no value beyond float32
rounding.

Departures from the published model, each as the program has it:

* the card's share: an MoE layer computes only the experts
  ``experts_first`` … ``experts_first + experts_held − 1`` of the
  ``n_experts`` its router scores; what the others would add is left out;
* rotary pairs are (i, i + d/2), the port's convention, where the
  checkpoint interleaves them (i, i + 1); with weights drawn at random the
  two differ only by a relabelling of the projections' columns;
* the weights are the program's own (bfloat16), cast to float32 one layer
  at a time, not the published FP8 checkpoint.

``params`` is the program's parameter tree (nested dicts of tensors:
``embed.table``, ``final_norm``, ``lm_head``, ``dense_layers`` and
``layers`` stacked on a leading axis); ``hp`` a dict of the sizes
(``hp_of``'s keys).  With ``fp8`` set every matrix product takes its operands
rounded to float8_e4m3fn (one scale a tensor): the same model one
precision below bfloat16, for a control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

F32 = torch.float32


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = _round_fp8(a), _round_fp8(b)
    return a @ b


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def yarn_get_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, hp: dict) -> torch.Tensor:
    """float64 (dim/2,): DeepseekV3YarnRotaryEmbedding's frequencies."""
    theta, orig = hp["rope_theta"], hp["rope_original_max_pos"]

    def corr_dim(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(corr_dim(hp["rope_beta_fast"])), 0)
    high = min(math.ceil(corr_dim(hp["rope_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    extra, inter = 1.0 / base, 1.0 / (hp["rope_factor"] * base)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1.0 - ramp)


def rope(x: torch.Tensor, positions: torch.Tensor, hp: dict) -> torch.Tensor:
    """x (S, H, d) rotated at ``positions`` (S,): pairs (i, i + d/2), the
    rotation times mscale(factor, mscale) / mscale(factor, mscale_all)."""
    d = x.shape[-1]
    ang = positions.to(torch.float64)[:, None] * yarn_inv_freq(d, hp).to(
        positions.device)
    m = (yarn_get_mscale(hp["rope_factor"], hp["rope_mscale"])
         / yarn_get_mscale(hp["rope_factor"], hp["rope_mscale_all_dim"]))
    cos = (torch.cos(ang) * m).to(F32)[:, None]
    sin = (torch.sin(ang) * m).to(F32)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def softmax_scale(hp: dict) -> float:
    m = (yarn_get_mscale(hp["rope_factor"], hp["rope_mscale_all_dim"])
         if hp["rope_mscale_all_dim"] else 1.0)
    return (hp["qk_nope_head_dim"] + hp["qk_rope_head_dim"]) ** -0.5 * m * m


def causal_attention(q, k, v, scale: float, fp8: bool, q_block: int = 512,
                     head_block: int = 16) -> torch.Tensor:
    """q, k (S, H, dq), v (S, H, dv) → (S, H, dv): softmax(q·k·scale)
    over the keys at or before each query, in blocks."""
    s, h, _ = q.shape
    out = torch.empty((s, h, v.shape[-1]), dtype=F32, device=q.device)
    for h0 in range(0, h, head_block):
        hs = slice(h0, h0 + head_block)
        kh = k[:, hs].transpose(0, 1).contiguous()    # (Hb, S, dq)
        vh = v[:, hs].transpose(0, 1).contiguous()
        for q0 in range(0, s, q_block):
            q1 = min(q0 + q_block, s)
            qh = q[q0:q1, hs].transpose(0, 1)         # (Hb, Qb, dq)
            sc = _mm(qh, kh[:, :q1].transpose(1, 2), fp8) * scale
            qpos = torch.arange(q0, q1, device=q.device)[:, None]
            kpos = torch.arange(q1, device=q.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            out[q0:q1, hs] = _mm(p, vh[:, :q1], fp8).transpose(0, 1)
    return out


def mla(x: torch.Tensor, lp: dict, hp: dict, positions: torch.Tensor,
        fp8: bool) -> torch.Tensor:
    """One sequence x (S, d) → the attention block's output (S, d)."""
    s = x.shape[0]
    h, nope, rope_d, vd = (hp["n_heads"], hp["qk_nope_head_dim"],
                           hp["qk_rope_head_dim"], hp["v_head_dim"])
    eps = hp["norm_eps"]
    cq = rmsnorm(_mm(x, lp["wq_a"], fp8), lp["q_ln"], eps)
    q = _mm(cq, lp["wq_b"], fp8).view(s, h, nope + rope_d)
    ckv = _mm(x, lp["wkv_a"], fp8)
    c_kv = rmsnorm(ckv[:, :hp["kv_lora_rank"]], lp["kv_ln"], eps)
    k_rope = rope(ckv[:, None, hp["kv_lora_rank"]:], positions, hp)
    kv = _mm(c_kv, lp["wkv_b"], fp8).view(s, h, nope + vd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], positions, hp)], -1)
    k = torch.cat([kv[..., :nope], k_rope.expand(s, h, rope_d)], -1)
    out = causal_attention(q, k, kv[..., nope:], softmax_scale(hp), fp8)
    return _mm(out.reshape(s, h * vd), lp["wo"], fp8)


def swiglu(x, w_gate, w_up, w_down, fp8: bool) -> torch.Tensor:
    g = _mm(x, w_gate, fp8)
    return _mm(g * torch.sigmoid(g) * _mm(x, w_up, fp8), w_down, fp8)


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          hp: dict, fp8: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) → weights (T, k), expert ids (T, k): sigmoid scores, the
    top k of scores + bias, their scores normalised and scaled."""
    scores = torch.sigmoid(_mm(x, router, fp8))
    idx = torch.topk(scores + bias, hp["top_k"], dim=-1).indices
    w = torch.gather(scores, 1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * hp["routed_scale"], idx


def moe(x: torch.Tensor, mp: dict, hp: dict, fp8: bool
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) → (the held experts' weighted outputs plus the shared
    expert's, the expert ids chosen (T, k)).  ``mp``'s expert weights are
    the held ones, ``experts_first`` on."""
    w, idx = route(x, mp["router"], mp["router_bias"], hp, fp8)
    sp = mp["shared"]
    out = swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"], fp8)
    for e in range(hp["experts_held"]):
        hit = idx == hp["experts_first"] + e                 # (T, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        y = swiglu(x[rows], mp["w_gate"][e], mp["w_up"][e],
                   mp["w_down"][e], fp8)
        out[rows] += (w[rows] * hit[rows]).sum(-1, keepdim=True) * y
    return out, idx


def _layer(params: dict, i: int, hp: dict) -> dict:
    """Layer ``i``'s weights, cast to float32."""
    dense = i < hp["first_k_dense"]
    key, j = ("dense_layers", i) if dense else (
        "layers", i - hp["first_k_dense"])

    def take(t):
        if isinstance(t, dict):
            return {n: take(v) for n, v in t.items()}
        return t[j].to(F32)

    return take(params[key])


def forward(params: dict, tokens: torch.Tensor, hp: dict,
            positions_out: Sequence[int], fp8: bool = False,
            device: Optional[torch.device] = None
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """tokens (B, S) → (float32 logits (B, len(positions_out), V) at those
    positions, and each MoE layer's chosen expert ids (B, S, k))."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(params, tokens, hp, list(positions_out), fp8,
                        device or tokens.device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@torch.no_grad()
def _forward(params, tokens, hp, positions_out, fp8, device):
    b, s = tokens.shape
    eps = hp["norm_eps"]
    tokens = tokens.to(device=device, dtype=torch.int64)
    positions = torch.arange(s, device=device)
    xs = [params["embed"]["table"][tokens[i]].to(F32) for i in range(b)]
    routes: List[List[torch.Tensor]] = []
    for i in range(hp["n_layers"]):
        lp = _layer(params, i, hp)
        ids = []
        for bi in range(b):
            x = xs[bi]
            x = x + mla(rmsnorm(x, lp["ln1"], eps), lp, hp, positions, fp8)
            h2 = rmsnorm(x, lp["ln2"], eps)
            if "moe" in lp:
                y, idx = moe(h2, lp["moe"], hp, fp8)
                ids.append(idx)
            else:
                m = lp["mlp"]
                y = swiglu(h2, m["w_gate"], m["w_up"], m["w_down"], fp8)
            xs[bi] = x + y
        if ids:
            routes.append(torch.stack(ids))
        del lp
    head = params["lm_head"].to(F32)
    fn = params["final_norm"].to(F32)
    logits = torch.stack([
        _mm(rmsnorm(x[positions_out], fn, eps), head, fp8) for x in xs])
    return logits, routes


def hp_of(cfg) -> Dict[str, float]:
    """The sizes ``forward`` reads, from an object with the program's
    config fields."""
    return {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "q_lora_rank": cfg.q_lora_rank, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "first_k_dense": cfg.first_k_dense,
            "n_layers": cfg.n_layers, "n_experts": cfg.moe_experts,
            "top_k": cfg.moe_top_k, "experts_first": cfg.experts_first,
            "experts_held": cfg.experts_held,
            "routed_scale": cfg.moe_routed_scale, "norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta, "rope_factor": cfg.rope_factor,
            "rope_original_max_pos": cfg.rope_original_max_pos,
            "rope_beta_fast": cfg.rope_beta_fast,
            "rope_beta_slow": cfg.rope_beta_slow,
            "rope_mscale": cfg.rope_mscale,
            "rope_mscale_all_dim": cfg.rope_mscale_all_dim}
