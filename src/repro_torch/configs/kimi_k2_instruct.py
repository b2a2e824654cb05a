"""kimi-k2-instruct-ep32 — Kimi-K2-Instruct as published, one card's share.

Source: https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json
(the equations of DeepSeek-V3, arXiv:2412.19437 §2.1).  61 layers, hidden
7,168, vocab 163,840, RMSNorm eps 1e-6; MLA with 64 heads, q_lora_rank
1,536, kv_lora_rank 512, qk_nope 128, qk_rope 64, v 128; YaRN (factor 32
over 4,096 positions, beta_fast 1, beta_slow 1, mscale 1, mscale_all_dim
1, theta 50,000); layer 0 a dense SwiGLU of width 18,432; then MoE layers
of 384 routed experts of width 2,048, 8 a token, sigmoid scores with a
score-correction bias (noaux_tc, one group), normalised, times 2.827, and
one shared expert.

The deployment this card stands for: each MoE layer's 384 experts over 32
cards (12 a card, expert parallelism), attention data-parallel, the layers
on pipeline stages.  This card holds the dense layer 0 and 8 MoE layers,
with experts 0–11 of each, and the whole vocabulary; the router keeps its
384 outputs and top-8.  Cut from the source: 61 → 9 layers, 384 → 12
experts held.  Every width is as published.
"""
from repro_torch.configs.base import MLAConfig, register_port_only

CONFIG = register_port_only(MLAConfig(
    name="kimi-k2-instruct-ep32",
    family="moe",
    n_layers=9,
    d_model=7168,
    n_heads=64,
    n_kv_heads=64,
    d_head=192,
    d_ff=18432,
    vocab=163840,
    moe_experts=384,
    moe_top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    rope_variant="yarn",
    rope_theta=50000.0,
    norm_eps=1e-6,
    remat=False,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    moe_routed_scale=2.827,
    rope_factor=32.0,
    rope_original_max_pos=4096,
    rope_beta_fast=1.0,
    rope_beta_slow=1.0,
    rope_mscale=1.0,
    rope_mscale_all_dim=1.0,
    experts_held=12,
    experts_first=0,
))
