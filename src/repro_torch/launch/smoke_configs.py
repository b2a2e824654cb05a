"""Reduced configs: same family/topology, laptop-scale dimensions
(counterpart of ``repro/launch/smoke_configs.py``, copied).

Per the assignment, smoke tests instantiate a REDUCED config of each
arch family (few layers, small width, few experts, tiny vocab) and run
a real forward/train step on CPU.  The parity tests hold the port to the
reference at these sizes; ``chip_smoke.py`` also runs one full config
(internlm2-1.8b) on the card.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    kw = dict(
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 4,
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        dtype="float32",
        attn_q_chunk=32,
        attn_kv_chunk=32,
        scan_layers=cfg.scan_layers,
        moment_dtype=cfg.moment_dtype,
    )
    if cfg.is_moe:
        kw.update(moe_experts=8, moe_top_k=2, moe_d_ff=64,
                  n_shared_experts=cfg.n_shared_experts)
    if cfg.rope_variant == "mrope":
        kw.update(mrope_sections=(2, 3, 3))
    if cfg.family == "hybrid":
        kw.update(n_layers=5, hybrid_attn_every=2,
                  hybrid_shared_attn_blocks=2, ssm_state=8,
                  ssm_head_dim=16, ssm_expand=2)
    if cfg.family == "ssm":
        kw.update(n_layers=6, slstm_every=3, ssm_expand=2, d_ff=0)
    if cfg.is_encdec:
        kw.update(enc_layers=2)
    if cfg.frontend != "none":
        kw.update(frontend_len=8)
    return dataclasses.replace(cfg, **kw)
