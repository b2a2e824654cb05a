"""The assigned input-shape grid and per-cell execution policy
(counterpart of ``repro/launch/shapes.py``, copied: pure Python)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}

ALL_SHAPES = tuple(SHAPES)


def cell_is_skipped(cfg: ArchConfig, shape: str) -> bool:
    """Assignment rule: long_500k only for sub-quadratic backbones."""
    return shape in cfg.skip_shapes


def local_batch(global_batch: int, dp: int) -> int:
    """Per-device batch; batch 1 cells keep 1 (seq shards instead)."""
    return max(1, global_batch // dp)


def choose_n_micro(cfg: ArchConfig, b_local: int, seq: int,
                   stash_budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation depth: bound the per-device residual stash.

    With remat + scan-over-layers the dominant live activation is one
    (B_µ, S, d) residual per layer; pick the smallest n_micro dividing
    b_local that keeps L·B_µ·S·d·2 under the budget.  MoE archs get a
    tighter budget: the (E·C, d) dispatch buffers + gathered expert
    weights scale with per-microbatch tokens (granite at n_micro=1
    measured 25 GiB of MoE transients).
    """
    n_layers = cfg.n_layers + cfg.enc_layers
    if cfg.is_moe:
        stash_budget_bytes = min(stash_budget_bytes, 1.5e9)
    for n_micro in range(1, b_local + 1):
        if b_local % n_micro:
            continue
        stash = (n_layers * (b_local // n_micro) * seq
                 * cfg.d_model * 2)
        if stash <= stash_budget_bytes:
            return n_micro
    return b_local


@dataclasses.dataclass(frozen=True)
class CellPlan:
    arch: str
    shape: str
    kind: str
    seq: int
    global_batch: int
    n_micro: int
    b_local: int


def plan_cell(cfg: ArchConfig, shape: str, dp: int) -> CellPlan:
    info = SHAPES[shape]
    bl = local_batch(info["global_batch"], dp)
    n_micro = (choose_n_micro(cfg, bl, info["seq"])
               if info["kind"] == "train" else 1)
    return CellPlan(arch=cfg.name, shape=shape, kind=info["kind"],
                    seq=info["seq"], global_batch=info["global_batch"],
                    n_micro=n_micro, b_local=bl)
