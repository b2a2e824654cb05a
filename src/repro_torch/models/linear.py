"""Linear models over b-bit codes and over VW sketches (counterpart of
``repro/models/linear.py``).

The b-bit weight is a (k, 2^b, C) float32 table — the expanded 2^b·k
weight vector reshaped, the reference's layout — plus a (C,) bias, held
in a plain dict of tensors ``{"table", "bias"}``.  Each b-bit forward
picks its arm through the cost model (``perf.choose``, op ``logits`` or
``logits_packed``); ``BBitLinearConfig.use_kernel`` pins it.  The VW model is a
dense (m, C) weight over the sketches, ``{"w", "bias"}``.  Binary
problems keep one output column (C = 1).  Every forward is
differentiable in the params: the b-bit ones through the kernels'
``torch.autograd.Function``s (``kernels.ops``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import perf
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.kernels import ops

# the table dtypes the kernels read (B5-B8 read float32 tables)
PARAM_DTYPES = ("float32",)


@dataclasses.dataclass(frozen=True)
class BBitLinearConfig:
    k: int
    b: int
    n_classes: int = 2
    # 'auto' → the cost model's arm (the kernel wherever it is eligible);
    # 'always' pins the kernel arm, 'never' the plain one.  'never' on a
    # CUDA tensor whose kernel applies raises: the port runs no plain
    # version on the card
    use_kernel: str = "auto"
    param_dtype: str = "float32"
    normalize: bool = False      # optional 1/sqrt(k) feature scaling

    @property
    def n_out(self) -> int:
        return 1 if self.n_classes == 2 else self.n_classes

    @property
    def n_weights(self) -> int:
        return self.k * (1 << self.b) * self.n_out + self.n_out


def check_param_dtype(cfg: BBitLinearConfig) -> None:
    """Raises for a table dtype the kernels do not read.  The reference's
    kernels read a bfloat16 table in place (one-hot products accumulated
    in float32, dW cast back to bfloat16); the port's B5-B8 read float32
    only, and a cast would change the model silently, so a bfloat16
    table waits for ROADMAP A7."""
    if cfg.param_dtype not in PARAM_DTYPES:
        raise ValueError(
            f"param_dtype={cfg.param_dtype!r}: the port's kernels (B5-B8) "
            f"read float32 tables only; a {cfg.param_dtype} table waits "
            "for ROADMAP A7 (no silent cast)")


def init_bbit_linear(cfg: BBitLinearConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> dict:
    """Zero table and bias, or a 0.01·N(0, 1) table drawn from
    ``generator`` (on the generator's device, then moved)."""
    check_param_dtype(cfg)
    dev = resolve_device(device)
    shape = (cfg.k, 1 << cfg.b, cfg.n_out)
    if generator is None:
        table = torch.zeros(shape, dtype=torch.float32, device=dev)
    else:
        table = 0.01 * torch.randn(shape, generator=generator,
                                   device=generator.device).to(dev)
    return {"table": table,
            "bias": torch.zeros((cfg.n_out,), dtype=torch.float32,
                                device=dev)}


def params_from_jax(params_np: Mapping[str, np.ndarray],
                    device: DeviceLike = None) -> dict:
    """The reference's params → the port's: b-bit ``{"table" (k, 2^b,
    n_out), "bias" (n_out,)}`` or VW ``{"w" (m, n_out), "bias"}``, as
    numpy arrays.  The layout is the same, so this converts the array
    type only."""
    dev = resolve_device(device)
    names = ("w", "bias") if "w" in params_np else ("table", "bias")
    return {name: torch.tensor(np.asarray(params_np[name], np.float32),
                               device=dev)
            for name in names}


def _forced_impl(cfg: BBitLinearConfig, op: str, shape: dict,
                 device: DeviceLike) -> Optional[str]:
    """The config's ``use_kernel`` as a pin of ``op``: 'always' → kernel,
    'never' → plain (refused on a card where the kernel applies),
    'auto' → None (``perf.choose`` decides)."""
    if cfg.use_kernel == "always" or cfg.use_kernel is True:
        return "kernel"
    if cfg.use_kernel == "never" or cfg.use_kernel is False:
        perf.refuse_plain_on_card(op, shape, device,
                                  "BBitLinearConfig(use_kernel='never')")
        return "plain"
    return None


def _logits_shape(cfg: BBitLinearConfig, rows: Optional[int]) -> dict:
    shape = {"k": cfg.k, "b": cfg.b, "v": 1 << cfg.b}
    if rows is not None:
        shape["rows"] = int(rows)
    return shape


def logits_impl(cfg: BBitLinearConfig, rows: Optional[int] = None,
                device: DeviceLike = "cpu") -> str:
    """The widened-codes arm on ``device``: 'kernel' (B7) | 'plain'."""
    shape = _logits_shape(cfg, rows)
    return perf.choose("logits", shape, device=device,
                       impl=_forced_impl(cfg, "logits", shape, device))


def logits_packed_impl(cfg: BBitLinearConfig, rows: Optional[int] = None,
                       device: DeviceLike = "cpu") -> str:
    """The packed-rows arm on ``device``: 'kernel' (B5) | 'plain'."""
    shape = _logits_shape(cfg, rows)
    return perf.choose("logits_packed", shape, device=device,
                       impl=_forced_impl(cfg, "logits_packed", shape,
                                         device))


def _finish(out: torch.Tensor, params, cfg: BBitLinearConfig
            ) -> torch.Tensor:
    if cfg.normalize:
        out = out / math.sqrt(cfg.k)
    return out + params["bias"].to(torch.float32)


def bbit_logits(params, codes: torch.Tensor, cfg: BBitLinearConfig,
                empty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integer codes (n, k) → logits (n, n_out) float32.  ``empty`` (bool
    (n, k), zero-coded OPH) drops the marked bins, by a plain torch
    gather as in the reference (``ops.bbit_linear_masked``)."""
    check_param_dtype(cfg)
    if empty is not None:
        out = ops.bbit_linear_masked(codes, params["table"], empty)
    else:
        shape = _logits_shape(cfg, codes.shape[0])
        out = ops.bbit_linear(
            codes, params["table"], shape=shape,
            impl=_forced_impl(cfg, "logits", shape, codes.device))
    return _finish(out, params, cfg)


def bbit_scores(params, codes: torch.Tensor, cfg: BBitLinearConfig,
                empty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary → (n,) margin, multiclass → (n, C) logits."""
    logits = bbit_logits(params, codes, cfg, empty=empty)
    return logits[:, 0] if cfg.n_classes == 2 else logits


def _classes(logits: torch.Tensor, n_classes: int) -> torch.Tensor:
    if n_classes == 2:
        return (logits[:, 0] > 0).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def predict_classes(params, codes: torch.Tensor,
                    cfg: BBitLinearConfig) -> torch.Tensor:
    """int32 (n,) class per row."""
    return _classes(bbit_logits(params, codes, cfg), cfg.n_classes)


def bbit_logits_packed(params, packed: torch.Tensor, cfg: BBitLinearConfig,
                       empty_packed: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Packed uint8 (n, ceil(k·b/8)) rows → logits (n, n_out) float32,
    differentiable in the params (B5 forward, B6 backward).
    ``empty_packed`` (the ``oph_zero`` packbits mask) drops the marked
    bins."""
    check_param_dtype(cfg)
    shape = _logits_shape(cfg, packed.shape[0])
    out = ops.bbit_linear_packed(
        packed, params["table"], cfg.k, cfg.b, empty=empty_packed,
        shape=shape,
        impl=_forced_impl(cfg, "logits_packed", shape, packed.device))
    return _finish(out, params, cfg)


def bbit_scores_packed(params, packed: torch.Tensor, cfg: BBitLinearConfig,
                       empty_packed: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Serving-shaped scores: binary → (n,) margin, multiclass → (n, C)."""
    logits = bbit_logits_packed(params, packed, cfg,
                                empty_packed=empty_packed)
    return logits[:, 0] if cfg.n_classes == 2 else logits


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class VWLinearConfig:
    m: int                       # number of VW buckets
    n_classes: int = 2

    @property
    def n_out(self) -> int:
        return 1 if self.n_classes == 2 else self.n_classes


@contextlib.contextmanager
def full_float32_matmul():
    """Sets ``torch.backends.cuda.matmul.allow_tf32 = False`` (no TF32 in
    float32 matmuls) for the ``with`` block, then restores the process's
    setting."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = before


def init_vw_linear(cfg: VWLinearConfig, device: DeviceLike = None) -> dict:
    """Zero weight (m, n_out) and bias, TRON's starting point."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=torch.float32, device=dev)
            for name, shape in (("w", (cfg.m, cfg.n_out)),
                                ("bias", (cfg.n_out,)))}


def vw_logits(params, sketches: torch.Tensor,
              cfg: VWLinearConfig) -> torch.Tensor:
    """Dense sketches (n, m) → logits (n, n_out): a plain float32
    ``torch.matmul``, as the reference leaves it to XLA, run inside
    ``full_float32_matmul`` so the card multiplies in full float32.
    Its gradient's matmul runs when autograd's backward does, outside
    this call: ``train_vw_liblinear`` holds the same scope around the
    whole fit for that."""
    with full_float32_matmul():
        out = torch.matmul(sketches, params["w"])
    return out + params["bias"]


def vw_predict(params, sketches: torch.Tensor,
               cfg: VWLinearConfig) -> torch.Tensor:
    """int32 (n,) class per row."""
    return _classes(vw_logits(params, sketches, cfg), cfg.n_classes)
