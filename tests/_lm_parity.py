"""Shared by the LM zoo's parity tests: the reference's and the port's
model of one architecture on the same weights and inputs.

The reference's params come from its own init (``jax.random.key``), go
to numpy (``jax.tree.map(np.asarray, ...)``: bfloat16 leaves as
``ml_dtypes`` arrays) and reach the port through
``repro_torch.models.api.params_from_jax``.  Inputs are numpy arrays
drawn from a seeded generator, handed to each package as its own
arrays.
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.launch.smoke_configs import reduced_config as j_reduced
from repro.models.api import get_model_api as j_get_api

from repro_torch.configs.base import get_config
from repro_torch.launch.smoke_configs import reduced_config
from repro_torch.models.api import get_model_api, params_from_jax


def configs(arch, **changes):
    """(the reference's reduced config, the port's), with ``changes``."""
    import dataclasses
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **changes)
    tcfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    return jcfg, tcfg


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def f32(x) -> np.ndarray:
    """A tensor or jax array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def batch_np(cfg, batch: int, seq: int, seed: int) -> dict:
    """Integer entries uniform in [0, vocab), float ones N(0, 1) float32
    (tests/test_arch_smoke.py's _batch_for, in numpy)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(
               np.int32),
           "targets": rng.integers(0, cfg.vocab, (batch, seq)).astype(
               np.int32)}
    extra = {"vision_stub": "vision_embeds",
             "audio_stub": "frames"}.get(cfg.frontend)
    if extra:
        out[extra] = rng.normal(size=(batch, cfg.frontend_len,
                                      cfg.d_model)).astype(np.float32)
    return out


def j_batch(batch_np_: dict, cfg) -> dict:
    out = {}
    for k, v in batch_np_.items():
        a = jnp.asarray(v)
        out[k] = a if v.dtype == np.int32 else a.astype(jnp.dtype(cfg.dtype))
    return out


def t_batch(batch_np_: dict, cfg, device="cpu") -> dict:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    out = {}
    for k, v in batch_np_.items():
        t = torch.from_numpy(v).to(device)
        out[k] = t if v.dtype == np.int32 else t.to(dt)
    return out


class Pair:
    """One architecture in both packages on the reference's weights.  The
    reference's loss, prefill and decode run under ``jax.jit`` (the same
    ops as eagerly, compiled once: a decode loop runs several times
    faster)."""

    def __init__(self, arch, seed=0, device="cpu", **changes):
        import dataclasses
        self.jcfg, self.tcfg = configs(arch, **changes)
        api = j_get_api(self.jcfg)
        self.japi = dataclasses.replace(
            api, loss_fn=jax.jit(api.loss_fn), prefill=jax.jit(api.prefill),
            decode_step=jax.jit(api.decode_step))
        self.tapi = get_model_api(self.tcfg)
        self.jparams = self.japi.init_params(jax.random.key(seed))
        self.tparams = params_from_jax(to_numpy(self.jparams), self.tcfg,
                                       device)
        self.device = device


@functools.lru_cache(maxsize=None)
def pair(arch, seed=0, **changes) -> Pair:
    return Pair(arch, seed, **changes)


def grow(full, pre):
    """tests/test_arch_smoke.py's grow: the prefill cache into
    init_cache's along the axis that differs."""
    if full.shape == pre.shape:
        return pre.astype(full.dtype)
    ax = [i for i, (a, c) in enumerate(zip(full.shape, pre.shape))
          if a != c][0]
    return jax.lax.dynamic_update_slice_in_dim(
        full, pre.astype(full.dtype), 0, axis=ax)
