"""qwen2-vl-2b — VLM backbone, M-RoPE [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  The vision
tower is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (B, n_patches, d_model) merged into the
token stream; M-RoPE carries (t, h, w) position ids.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    rope_variant="mrope",
    mrope_sections=(16, 24, 24),
    frontend="vision_stub",
    frontend_len=256,            # patches per image
    skip_shapes=("long_500k",),
))
