"""zamba2-7b — hybrid Mamba2 + shared attention blocks
[arXiv:2411.15242; unverified].

81L d_model=3584 32H (GQA kv=32 → MHA) d_ff=14336 vocab=32000,
ssm_state=64.  The layer stack is Mamba2 blocks with a *shared*
attention(+MLP) block applied every ``hybrid_attn_every`` layers,
alternating between ``hybrid_shared_attn_blocks`` weight sets — the
Zamba weight-sharing scheme.  Sub-quadratic backbone → runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
    hybrid_shared_attn_blocks=2,
    rope_variant="standard",
))
