"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.  Every ``slstm_every``-th
block is a (recurrent) sLSTM; the rest are (chunk-parallel) mLSTM.
Recurrent state is O(1) in sequence length → runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_head=256,
    d_ff=0,                  # xLSTM blocks have no separate FFN
    vocab=50304,
    ssm_expand=2,
    slstm_every=6,
    rope_variant="none",
))
