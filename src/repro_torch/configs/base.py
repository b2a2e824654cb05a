"""Architecture config schema and registry (counterpart of
``repro/configs/base.py``, copied as data: the same fields, defaults and
parameter counts).

``MLAConfig`` extends the schema with what DeepSeek-V3-style models need
(latent attention, YaRN, leading dense layers, sigmoid routing and the
share of experts a card holds).  Such configurations are the port's own:
``register_port_only`` keeps them in a table apart from the mirrored
registry, and ``get_config`` resolves both."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 → d_model // n_heads

    # -- MoE ----------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity: float = 1.25
    n_shared_experts: int = 0
    # serving-path MoE dispatch: 'psum' (baseline; FSDP weights gathered
    # per step) | 'weight_stationary' (experts 2D-sharded over
    # data×model, tokens all_to_all'd — §Perf)
    moe_serving_dispatch: str = "psum"
    moe_pad_to: int = 16             # expert-count padding multiple

    # -- position encoding ----------------------------------------------------
    rope_variant: str = "standard"   # standard | partial | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # -- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    hybrid_attn_every: int = 6       # zamba2: shared attn block cadence
    hybrid_shared_attn_blocks: int = 2
    slstm_every: int = 6             # xlstm: sLSTM cadence (rest mLSTM)

    # -- encoder-decoder ------------------------------------------------------
    enc_layers: int = 0              # >0 → enc-dec (audio/vlm encoders)

    # -- modality frontend (STUB: precomputed embeddings enter directly) -----
    frontend: str = "none"           # none | vision_stub | audio_stub
    frontend_len: int = 0            # frames/patches per example

    # -- embeddings -----------------------------------------------------------
    embedding: str = "dense"         # dense | bbit_hash (paper technique)
    hash_k: int = 8
    hash_b: int = 12

    # -- numerics / execution -------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: bool = True
    remat_policy: str = "full"       # full | dots (save matmul outputs)
    scan_layers: bool = True
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    attn_impl: str = "loop"          # loop (exact FLOP probes) | scan
    # replicate KV heads up to this count for prefill/decode caches so
    # they shard over 'model' (removes S-shard merges + resharding
    # copies in decode; exact GQA transform) — §Perf
    kv_repeat_to: int = 0
    # pad q heads (group-aware) + replicate kv so heads divide the model
    # axis; attention then shards 16-way instead of running replicated
    # (exact: padded q rows are zero and sliced off) — §Perf
    attn_pad_heads: bool = False
    moment_dtype: str = "float32"    # adamw moments: float32|bfloat16|int8

    # -- shapes this arch must skip (assignment rules) ------------------------
    skip_shapes: Tuple[str, ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.family in ("hybrid", "ssm"):
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            ssm = (d * (2 * d_in + 2 * self.ssm_state + nh)   # in_proj
                   + d_in * d                                  # out_proj
                   + 3 * self.ssm_conv_width * d_in + 2 * nh)
            if self.family == "ssm":
                block = ssm + 2 * d  # norms; xlstm approximated as ssm-ish
            else:
                block = ssm + 2 * d
            n_attn = (self.hybrid_shared_attn_blocks * (attn + 3 * d * self.d_ff)
                      if self.family == "hybrid" else 0)
            total = self.n_layers * block + n_attn
        elif self.is_moe:
            ffn = 3 * d * self.moe_d_ff
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            router = d * self.moe_experts
            block = attn + self.moe_experts * ffn + shared + router + 2 * d
            total = self.n_layers * block
        else:
            block = attn + 3 * d * self.d_ff + 2 * d
            total = self.n_layers * block
            if self.is_encdec:
                total += self.enc_layers * (2 * attn + 3 * d * self.d_ff
                                            + 3 * d)
        total += self.vocab * d * (1 if self.embedding == "bbit_hash"
                                   else 2)
        if self.embedding == "bbit_hash":
            total += self.hash_k * (1 << self.hash_b) * d
        return int(total)

    def n_active_params(self) -> int:
        """Active (per-token) params — MoE counts top_k experts only."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * (
            self.moe_experts * 3 * d * self.moe_d_ff)
        return int(dense + self.n_layers
                   * self.moe_top_k * 3 * d * self.moe_d_ff)


@dataclasses.dataclass(frozen=True)
class MLAConfig(ArchConfig):
    """A DeepSeek-V3-style decoder (arXiv:2412.19437 §2.1): multi-head
    latent attention, YaRN rope, ``first_k_dense`` dense SwiGLU layers of
    width ``d_ff``, then MoE layers routed by sigmoid scores over
    ``moe_experts`` experts, of which this card holds ``experts_held``
    (ids ``experts_first`` on).  ``d_head`` is q·k's width (nope + rope)."""
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    first_k_dense: int = 0
    # routing: sigmoid scores, a score-correction bias used for the choice
    # only, the chosen scores normalised to sum 1, times routed_scale
    moe_routed_scale: float = 1.0
    # YaRN (rope_variant "yarn"): the context-extension factor, the
    # trained context, the correction range's rotations and the mscales
    rope_factor: float = 1.0
    rope_original_max_pos: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    # the experts this card holds of each MoE layer
    experts_held: int = 0
    experts_first: int = 0

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense

    def mla_params(self) -> int:
        d, h = self.d_model, self.n_heads
        qk = self.qk_nope_head_dim + self.qk_rope_head_dim
        return (d * self.q_lora_rank + self.q_lora_rank
                + self.q_lora_rank * h * qk
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank
                + self.kv_lora_rank * h * (self.qk_nope_head_dim
                                           + self.v_head_dim)
                + h * self.v_head_dim * d + 2 * d)

    def n_params(self) -> int:
        """The parameters this card holds."""
        d = self.d_model
        expert = 3 * d * self.moe_d_ff
        moe = (self.experts_held * expert + self.n_shared_experts * expert
               + d * self.moe_experts + self.moe_experts)
        return int(self.n_layers * self.mla_params()
                   + self.first_k_dense * 3 * d * self.d_ff
                   + self.n_moe_layers * moe
                   + 2 * self.vocab * d + d)

    def n_active_params(self) -> int:
        """A token's parameters on this card, counting the top-k routed
        experts at their share here (k · held / experts)."""
        d = self.d_model
        expert = 3 * d * self.moe_d_ff
        routed = self.moe_top_k * self.experts_held / self.moe_experts
        return int(self.n_params() - self.n_moe_layers
                   * (self.experts_held - routed) * expert)


_REGISTRY: Dict[str, ArchConfig] = {}
# the port's own configurations, outside the registry mirrored from the
# reference (``list_configs`` and ``configs.archs.ALL_ARCHS`` leave them out)
_PORT_ONLY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def register_port_only(cfg: ArchConfig) -> ArchConfig:
    _PORT_ONLY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # populate the registry lazily
    import repro_torch.configs.archs  # noqa: F401
    import repro_torch.configs.kimi_k2_instruct  # noqa: F401
    if name in _PORT_ONLY and name not in _REGISTRY:
        return _PORT_ONLY[name]
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    import repro_torch.configs.archs  # noqa: F401
    return dict(_REGISTRY)
