"""chatglm3-6b — partial (2d-derived) RoPE, GQA [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.  ChatGLM applies
rotary embedding to half the head dims (partial rotary factor 0.5) —
the 'RoPE 2d' lineage of GLM — implemented as rope_variant='partial'.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab=65024,
    rope_variant="partial",
    skip_shapes=("long_500k",),
))
