"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 (+1 shared expert).  Assignment table values are
authoritative (the real Kimi K2 uses MLA; the assignment specifies GQA
kv=8, which we follow).  int8 AdamW moments are required to fit 1.04T
params in 512×16 GB (DESIGN.md §6).

The published model (https://huggingface.co/moonshotai/Kimi-K2-Instruct/
blob/main/config.json: latent attention, YaRN, a leading dense layer,
sigmoid routing) is ``kimi_k2_instruct.py``'s ``kimi-k2-instruct-ep32``,
one card's share of it.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,
    d_ff=2048,
    vocab=163840,
    moe_experts=384,
    moe_top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    rope_variant="standard",
    rope_theta=50000.0,
    moment_dtype="int8",
    skip_shapes=("long_500k",),   # full attention — O(S²) at 500k
))
