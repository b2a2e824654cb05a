"""The least work of a latent-attention MoE model's prefill, from its
config's sizes (a dict of the program's config fields) and the shapes
alone: matrix-product FLOPs, two a multiply-add.

* ``attention_flops``: causal attention of each layer, q·k at the
  nope + rope width and p·v at v's, counting only the (query, key) pairs
  at or below the diagonal: H · (qk + v) · S(S+1) a sequence and layer;
* ``token_flops``: the projections a token passes outside attention —
  MLA's down- and up-projections and output, the dense layers' SwiGLU,
  each MoE layer's router, shared expert and its routed experts at the
  share held here (top_k · held / experts of a token);
* ``prefill_flops``: both, over B sequences of S tokens, and the head at
  the last position.

The card's rate is NVIDIA's published dense bf16 tensor-core rate of the
H100 SXM (data sheet, no sparsity, at 700 W), kept here.
"""
from __future__ import annotations

BF16_DENSE_FLOPS_PER_S = 989.4e12
# the fused attention kernels on the device trace (cuDNN's SDPA kernels, or
# a flash kernel), by a part of their names
ATTENTION_KERNELS = ("sdpa", "flash")


def attention_flops(m: dict, batch: int, seq: int) -> float:
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    per_layer = m["n_heads"] * (qk + m["v_head_dim"]) * seq * (seq + 1)
    return float(batch * m["n_layers"] * per_layer)


def token_flops(m: dict) -> float:
    d, h = m["d_model"], m["n_heads"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    ql, kl = m["q_lora_rank"], m["kv_lora_rank"]
    mla = (d * ql + ql * h * (nope + rope) + d * (kl + rope)
           + kl * h * (nope + vd) + h * vd * d)
    expert = 3 * d * m["moe_d_ff"]
    moe = (d * m["moe_experts"] + m["n_shared_experts"] * expert
           + m["moe_top_k"] * m["experts_held"] / m["moe_experts"] * expert)
    dense = 3 * d * m["d_ff"]
    n_moe = m["n_layers"] - m["first_k_dense"]
    return 2.0 * (m["n_layers"] * mla + m["first_k_dense"] * dense
                  + n_moe * moe)


def prefill_flops(m: dict, batch: int, seq: int) -> float:
    return (batch * seq * token_flops(m) + attention_flops(m, batch, seq)
            + 2.0 * batch * m["d_model"] * m["vocab"])
