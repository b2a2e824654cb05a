"""Imports every architecture config module to populate the registry."""
from repro_torch.configs import (  # noqa: F401
    kimi_k2_1t_a32b,
    granite_moe_3b_a800m,
    deepseek_67b,
    chatglm3_6b,
    yi_9b,
    internlm2_1_8b,
    zamba2_7b,
    xlstm_350m,
    qwen2_vl_2b,
    seamless_m4t_large_v2,
)

ALL_ARCHS = (
    "kimi-k2-1t-a32b",
    "granite-moe-3b-a800m",
    "deepseek-67b",
    "chatglm3-6b",
    "yi-9b",
    "internlm2-1.8b",
    "zamba2-7b",
    "xlstm-350m",
    "qwen2-vl-2b",
    "seamless-m4t-large-v2",
)
