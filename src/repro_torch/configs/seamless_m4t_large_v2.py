"""seamless-m4t-large-v2 — enc-dec, multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (kv=16 → MHA) d_ff=8192 vocab=256206.  Interpreted
as 24 encoder + 24 decoder layers (the real model's w2v-BERT speech
encoder + NLLB text decoder; DESIGN.md §5).  The audio frontend is a
STUB: ``input_specs()`` supplies precomputed frame embeddings
(B, frames, d_model) to the encoder.  Decode shapes exercise the text
decoder with cached cross-attention.  256k vocab → the prime target for
the paper's b-bit hashed-embedding compression (§Perf).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                 # decoder layers
    enc_layers=24,               # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab=256206,
    rope_variant="none",         # learned/sinusoidal in the original;
                                 # positions handled by the enc/dec stubs
    frontend="audio_stub",
    frontend_len=1024,           # encoder frames per utterance
    skip_shapes=("long_500k",),
))
