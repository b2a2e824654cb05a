"""One model contract across the ten architecture families (counterpart
of ``repro/models/api.py``).

``get_model_api(cfg)`` returns a ``ModelAPI`` whose members callers use
without family-specific branches.  Batches are dicts of tensors:

  train:   {"tokens", "targets"} (+"vision_embeds" | +"frames")
  prefill: {"tokens"} (+ the modality's extra)
  decode:  {"token"} against (cache, cache_len)

The computation runs on the device of the params and the batch.
``init_params(generator, device=None)`` draws on the generator's device
and puts the params on ``device`` (``None`` is ``cuda:0``);
``init_cache(batch, max_len, device=None)`` likewise.

With a ``mesh`` (a ``DeviceMesh``, ``launch/mesh.py``) the params, cache
and batch are DTensors laid out by ``param_pspecs(mesh)`` /
``cache_pspecs(mesh)`` and the batch specs (``launch/steps.py``); the
functions run under DTensor's implicit replication, so the plain
tensors the models build count as replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import bfloat16
from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.distributed import shardings as sh
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.layers import ParamInit
from repro_torch.tree import leaves, paths, unflatten


class BatchShape(NamedTuple):
    """A batch entry's shape and torch dtype (the reference gives a
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    init_params: Callable    # (generator, device=None) -> params
    loss_fn: Callable        # (params, batch, mesh=None) -> scalar
    prefill: Callable        # (params, batch, mesh=None) -> (logits, cache)
    decode_step: Callable    # (params, batch, cache, cache_len, mesh=None)
    init_cache: Callable     # (batch_size, max_len, device=None) -> cache
    param_pspecs: Callable   # (mesh) -> tree of P
    batch_shapes: Callable   # (batch, seq) -> {name: BatchShape}
    decode_shapes: Callable  # (batch,) -> {name: BatchShape}
    cache_pspecs: Callable = None   # (mesh) -> tree of P


def _kv_cache_pspec(cfg: ArchConfig, mesh, lead: int = 1):
    """(lead…, B, S, KV, hd): B over dp; heads over 'model' when they
    divide, otherwise the sequence dim (exact: the decode step merges
    the partial softmax stats over 'model')."""
    dp = tf_lib.dp_axes_of(mesh) or None
    mdl = sh.mp_size(mesh)
    kv_eff = max(cfg.n_kv_heads, cfg.kv_repeat_to or 0)
    leadspec = (None,) * lead
    if kv_eff % mdl == 0:
        spec = sh.P(*leadspec, dp, None, "model", None)
    else:
        spec = sh.P(*leadspec, dp, "model", None, None)
    return {"k": spec, "v": spec}


def _hybrid_cache_pspecs(cfg: ArchConfig, mesh):
    from repro_torch.models import ssm as ssm_lib
    dp = tf_lib.dp_axes_of(mesh) or None
    mdl = sh.mp_size(mesh)
    _, nh, _ = ssm_lib.ssm_dims(cfg)
    h_spec = "model" if nh % mdl == 0 else None

    def ssm_spec(lead):
        return (sh.P(*((None,) * lead), dp, h_spec, None, None),   # h
                sh.P(*((None,) * lead), dp, None, "model"))        # conv

    groups, per, tail = hybrid_lib._hybrid_layout(cfg)
    out = {"mamba": ssm_spec(2),
           "attn": _kv_cache_pspec(cfg, mesh, lead=1)}
    if tail:
        out["mamba_tail"] = ssm_spec(1)
    return out


def _xlstm_cache_pspecs(cfg: ArchConfig, mesh):
    from repro_torch.models import xlstm as xlstm_lib
    dp = tf_lib.dp_axes_of(mesh) or None
    mdl = sh.mp_size(mesh)
    _, p = xlstm_lib.xlstm_dims(cfg)
    p_spec = "model" if p % mdl == 0 else None
    ps = cfg.d_model // cfg.n_heads
    ps_spec = "model" if ps % mdl == 0 else None
    return {
        "mlstm": (sh.P(None, None, dp, None, p_spec, None),   # C
                  sh.P(None, None, dp, None, p_spec),         # n
                  sh.P(None, None, dp, None)),                # m
        "slstm": (sh.P(None, dp, None, ps_spec),) * 4,
    }


def _pspec_fns(cfg: ArchConfig):
    """(param_pspecs(mesh), cache_pspecs(mesh)) of the family."""
    fam = cfg.family
    if isinstance(cfg, MLAConfig):
        return (lambda mesh: tf_lib._refuse_mesh(cfg, mesh),
                lambda mesh: tf_lib._refuse_mesh(cfg, mesh))
    if fam in ("dense", "moe", "vlm"):
        return (lambda mesh: tf_lib.decoder_param_pspecs(cfg, mesh),
                lambda mesh: _kv_cache_pspec(cfg, mesh, lead=1))
    if fam == "hybrid":
        return (lambda mesh: hybrid_lib.hybrid_param_pspecs(cfg, mesh),
                lambda mesh: _hybrid_cache_pspecs(cfg, mesh))
    if fam == "ssm":
        return (lambda mesh: hybrid_lib.xlstm_param_pspecs(cfg, mesh),
                lambda mesh: _xlstm_cache_pspecs(cfg, mesh))
    if fam == "audio":
        return (lambda mesh: encdec_lib.encdec_param_pspecs(cfg, mesh),
                lambda mesh: {"self": _kv_cache_pspec(cfg, mesh, lead=1),
                              "cross": _kv_cache_pspec(cfg, mesh, lead=1)})
    raise ValueError(f"unknown family {fam!r}")


def _on_mesh(mesh, fn, *args):
    """``fn(*args)``, under implicit replication when ``mesh`` is set."""
    if mesh is None:
        return fn(*args)
    with sh.implicit_replication():
        return fn(*args)


def _std_batch_shapes(cfg: ArchConfig):
    def f(batch: int, seq: int) -> Dict[str, BatchShape]:
        s = {"tokens": BatchShape((batch, seq), torch.int32),
             "targets": BatchShape((batch, seq), torch.int32)}
        extra = {"vision_stub": "vision_embeds",
                 "audio_stub": "frames"}.get(cfg.frontend)
        if extra:
            s[extra] = BatchShape((batch, cfg.frontend_len, cfg.d_model),
                                  tf_lib._dtype(cfg))
        return s
    return f


def _decode_shapes(cfg: ArchConfig):
    def f(batch: int) -> Dict[str, BatchShape]:
        return {"token": BatchShape((batch, 1), torch.int32)}
    return f


def _family_fns(cfg: ArchConfig):
    """(init(ParamInit), logits(params, batch, mesh), prefill(params,
    batch, mesh), decode(params, batch, cache, cache_len, mesh),
    init_cache(b, s, device))."""
    fam = cfg.family
    if isinstance(cfg, MLAConfig):
        decoder = tf_lib.MLADecoder(cfg)      # keeps its decode graphs
        return (
            lambda init: tf_lib.init_mla_params(cfg, init),
            lambda p, b, m: tf_lib.mla_forward_train(p, b["tokens"], cfg, m),
            lambda p, b, m: tf_lib.mla_prefill(p, b["tokens"], cfg, m),
            lambda p, b, c, cl, m: decoder(p, b["token"], c, cl, m),
            lambda b, s, device: tf_lib.init_mla_cache(cfg, b, s,
                                                       device=device))
    if fam in ("dense", "moe", "vlm"):
        return (
            lambda init: tf_lib.init_decoder_params(cfg, init),
            lambda p, b, m: tf_lib.forward_train(
                p, b["tokens"], cfg, m,
                vision_embeds=b.get("vision_embeds")),
            lambda p, b, m: tf_lib.prefill(
                p, b["tokens"], cfg, m,
                vision_embeds=b.get("vision_embeds")),
            lambda p, b, c, cl, m: tf_lib.decode_step(p, b["token"], c, cl,
                                                      cfg, m),
            lambda b, s, device: tf_lib.init_cache(cfg, b, s,
                                                   device=device))
    if fam == "hybrid":
        return (
            lambda init: hybrid_lib.init_hybrid_params(cfg, init),
            lambda p, b, m: hybrid_lib.hybrid_forward_train(
                p, b["tokens"], cfg, m),
            lambda p, b, m: hybrid_lib.hybrid_prefill(p, b["tokens"], cfg,
                                                      m),
            lambda p, b, c, cl, m: hybrid_lib.hybrid_decode_step(
                p, b["token"], c, cl, cfg, m),
            lambda b, s, device: hybrid_lib.init_hybrid_cache(
                cfg, b, s, device=device))
    if fam == "ssm":
        return (
            lambda init: hybrid_lib.init_xlstm_stack_params(cfg, init),
            lambda p, b, m: hybrid_lib.xlstm_forward_train(
                p, b["tokens"], cfg, m),
            lambda p, b, m: hybrid_lib.xlstm_prefill(p, b["tokens"], cfg,
                                                     m),
            lambda p, b, c, cl, m: hybrid_lib.xlstm_decode_step(
                p, b["token"], c, cl, cfg, m),
            lambda b, s, device: hybrid_lib.init_xlstm_cache(
                cfg, b, s, device=device))
    if fam == "audio":
        return (
            lambda init: encdec_lib.init_encdec_params(cfg, init),
            lambda p, b, m: encdec_lib.forward_train(
                p, b["tokens"], b["frames"], cfg, m),
            lambda p, b, m: encdec_lib.prefill(p, b["tokens"], b["frames"],
                                               cfg, m),
            lambda p, b, c, cl, m: encdec_lib.decode_step(
                p, b["token"], c, cl, cfg, m),
            lambda b, s, device: encdec_lib.init_cache(cfg, b, s,
                                                       device=device))
    raise ValueError(f"unknown family {fam!r}")


def get_model_api(cfg: ArchConfig) -> ModelAPI:
    init, logits, prefill, decode, cache = _family_fns(cfg)
    param_pspecs, cache_pspecs = _pspec_fns(cfg)

    def init_params(generator: Optional[torch.Generator],
                    device: DeviceLike = None):
        dev = torch.device("meta") if device is not None and \
            torch.device(device).type == "meta" else resolve_device(device)
        if generator is None and dev.type != "meta":
            raise ValueError("init_params needs a torch.Generator (or "
                             "device='meta' for the shapes alone)")
        return init(ParamInit(generator, dev))

    def loss_fn(params, batch, mesh=None):
        return _on_mesh(mesh, lambda: tf_lib.xent_loss(
            logits(params, batch, mesh), batch["targets"]))

    def prefill_fn(params, batch, mesh=None):
        return _on_mesh(mesh, prefill, params, batch, mesh)

    def decode_fn(params, batch, cache_, cache_len, mesh=None):
        return _on_mesh(mesh, decode, params, batch, cache_, cache_len,
                        mesh)

    def init_cache(batch: int, max_len: int, device: DeviceLike = None):
        return cache(batch, max_len, resolve_device(device))

    return ModelAPI(cfg=cfg, init_params=init_params, loss_fn=loss_fn,
                    prefill=prefill_fn, decode_step=decode_fn,
                    init_cache=init_cache, param_pspecs=param_pspecs,
                    batch_shapes=_std_batch_shapes(cfg),
                    decode_shapes=_decode_shapes(cfg),
                    cache_pspecs=cache_pspecs)


# ---------------------------------------------------------------------------
# the weight carrier
# ---------------------------------------------------------------------------
def params_from_jax(tree_np: Any, cfg: ArchConfig,
                    device: DeviceLike = None) -> Any:
    """The reference's param tree of ``cfg``, as numpy arrays (bfloat16
    leaves as ``ml_dtypes`` arrays or 2-byte words) → the port's tensors
    on ``device``.  The tree, every leaf's shape and its dtype must be
    those of the port's own init (checked against ``init_params`` on the
    meta device); bfloat16 words move bit for bit (``bfloat16.py``)."""
    dev = resolve_device(device)
    template = get_model_api(cfg).init_params(None, device="meta")
    names = paths(template)
    got_names = paths(tree_np)
    if sorted(got_names) != sorted(names):
        missing = sorted(set(names) - set(got_names))
        extra = sorted(set(got_names) - set(names))
        raise ValueError(f"{cfg.name}: the param tree differs from the "
                         f"port's: missing {missing}, unexpected {extra}")
    out = []
    for name, want, arr in zip(names, leaves(template), leaves(tree_np)):
        arr = np.asarray(arr)
        if bfloat16.is_bfloat16_array(arr):
            t = bfloat16.from_numpy(arr)
        else:
            t = torch.from_numpy(np.array(arr))
        if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
            raise ValueError(
                f"{cfg.name}: {name} is {tuple(t.shape)} {t.dtype}, the "
                f"port's init gives {tuple(want.shape)} {want.dtype}")
        out.append(t.to(dev))
    return unflatten(template, out)
