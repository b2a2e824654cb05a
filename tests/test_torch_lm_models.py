"""The LM zoo's ten architectures in the port against the reference
(ROADMAP A6a), at ``reduced_config`` in float32 on the CPU, on the
reference's weights carried by ``params_from_jax``: the init tree (and
the full configs' param shapes), the loss and every gradient, prefill's
logits and cache, and one decode step; then internlm2 at bfloat16 and
with the b-bit hashed embedding, ``kv_repeat_to``, ``remat`` and
``scan_layers``, and the mesh paths on a one-rank mesh.

Tolerances.  float32 with the reductions in another order: the loss
within 1e-5 relative, logits and caches within 1e-4 absolute (|logit|
is O(1) here; the largest gap seen is 1e-5), each gradient leaf within
1e-4 of its largest magnitude (the largest seen: 4e-6 of it, xlstm's).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _lm_parity import (Pair, batch_np, f32, grow, j_batch, pair, t_batch,
                        to_numpy)
from repro.configs.archs import ALL_ARCHS
from repro.configs.base import get_config as j_get_config
from repro.models.api import get_model_api as j_get_api

from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.models.api import get_model_api, params_from_jax
from repro_torch.serving.engine import grow_cache
from repro_torch.train.steps import _value_and_grad

LOGIT_ATOL = 1e-4
GRAD_REL = 1e-4
LOSS_RTOL = 1e-5


def _leaf_meta(tree_):
    return [(tuple(np.shape(x)), str(x.dtype).replace("torch.", ""))
            for x in tree.leaves(tree_)]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_tree_shapes_and_dtypes_match_reference(arch):
    p = pair(arch)
    mine = p.tapi.init_params(torch.Generator().manual_seed(0),
                              device="cpu")
    assert tree.paths(mine) == tree.paths(to_numpy(p.jparams))
    assert _leaf_meta(mine) == _leaf_meta(p.jparams)
    # the full published config, shapes only (meta / eval_shape)
    full = get_model_api(get_config(arch)).init_params(None, device="meta")
    want = jax.eval_shape(j_get_api(j_get_config(arch)).init_params,
                          jax.random.key(0))
    assert _leaf_meta(full) == _leaf_meta(want)


def _grads_close(p: Pair, tg: dict, jg, rel: float):
    names = tree.paths(p.tparams)
    for name, ref in zip(names, tree.leaves(to_numpy(jg))):
        ref = np.asarray(ref, np.float32)
        got = f32(tg[name])
        assert got.shape == ref.shape, name
        if ref.size:
            scale = max(float(np.abs(ref).max()), 1e-3)
            err = float(np.abs(got - ref).max())
            assert err <= rel * scale, (name, err, scale)


def _decode_pair(p: Pair, jcache, tcache, tok, cache_len, max_len):
    jc = jax.tree.map(grow, p.japi.init_cache(tok.shape[0], max_len),
                      jcache)
    tc = grow_cache(p.tapi.init_cache(tok.shape[0], max_len,
                                      device=p.device), tcache)
    jd, jc2 = p.japi.decode_step(p.jparams, {"token": jnp.asarray(tok)},
                                 jc, jnp.asarray(cache_len, jnp.int32))
    td, tc2 = p.tapi.decode_step(p.tparams, {"token": torch.from_numpy(tok)},
                                 tc, cache_len)
    return (jd, jc2), (td, tc2)


def check_pair(p: Pair, seed=3, seq=16, logit_atol=LOGIT_ATOL,
               grad_rel=GRAD_REL, loss_rtol=LOSS_RTOL, grads=True):
    bnp = batch_np(p.tcfg, 2, seq, seed)
    jb, tb = j_batch(bnp, p.jcfg), t_batch(bnp, p.tcfg)
    if grads:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda q: p.japi.loss_fn(q, jb)))(p.jparams)
        tl, tg = _value_and_grad(lambda q, b: p.tapi.loss_fn(q, b),
                                 p.tparams, (tb,), False)
        _grads_close(p, tg, jg, grad_rel)
    else:
        jl = p.japi.loss_fn(p.jparams, jb)
        tl = p.tapi.loss_fn(p.tparams, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=loss_rtol)
    pre_j = {k: v for k, v in jb.items() if k != "targets"}
    pre_t = {k: v for k, v in tb.items() if k != "targets"}
    jlog, jcache = p.japi.prefill(p.jparams, pre_j)
    with torch.no_grad():
        tlog, tcache = p.tapi.prefill(p.tparams, pre_t)
    np.testing.assert_allclose(f32(tlog), f32(jlog), rtol=0,
                               atol=logit_atol)
    for a, b in zip(tree.leaves(tcache), tree.leaves(jcache)):
        np.testing.assert_allclose(f32(a), f32(b), rtol=0,
                                   atol=logit_atol)
    with torch.no_grad():
        (jd, jc2), (td, tc2) = _decode_pair(
            p, jcache, tcache, bnp["tokens"][:, :1], seq, seq + 4)
    np.testing.assert_allclose(f32(td), f32(jd), rtol=0, atol=logit_atol)
    for a, b in zip(tree.leaves(tc2), tree.leaves(jc2)):
        np.testing.assert_allclose(f32(a), f32(b), rtol=0,
                                   atol=logit_atol)
    return float(tl), float(jl)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_grads_prefill_decode_match_reference(arch):
    check_pair(pair(arch))


def test_bfloat16_internlm2_within_its_bound():
    """internlm2 at bfloat16 on both sides.  Each package rounds every
    matmul output, norm and residual add to bfloat16 (2^-9 relative), at
    other points and in another order, over 4 layers of about 10 such
    ops: logits of |x| <= 4 then differ by a few bfloat16 ulps of O(1)
    (2^-7 at 1.0 to 2^-6 at 2-4), so the bound is 0.1 absolute (13 ulps
    at 1.0; 0.047 seen), the loss (float32 from the logits on, a mean of
    32 tokens) 1e-2 relative (1.1e-4 seen) and each gradient leaf 0.1 of
    its largest magnitude (0.024 seen).  MoE and the scans are left out:
    one bfloat16 flip there picks another expert or compounds over the
    sequence (kimi's logits 1.3 apart, xlstm's gradients 0.55)."""
    p = Pair("internlm2-1.8b", dtype="bfloat16")
    assert tree.leaves(p.tparams)[0].dtype == torch.bfloat16
    check_pair(p, logit_atol=0.1, grad_rel=0.1, loss_rtol=1e-2)


def test_bbit_hash_embedding_internlm2():
    p = pair("internlm2-1.8b", embedding="bbit_hash", hash_k=8, hash_b=6)
    assert set(p.tparams["embed"]) == {"hash_tables"}
    assert p.tparams["embed"]["hash_tables"].shape == (8, 64, 64)
    check_pair(p)


def test_kv_repeat_to_matches_reference_and_itself():
    """kv_repeat_to=4 on chatglm3 (each of its 2 KV heads twice, one per
    query head) in prefill and decode: against the reference, and the
    logits within float32 rounding of the model without it."""
    p = pair("chatglm3-6b", kv_repeat_to=4)
    assert p.tapi.init_cache(2, 20, device="cpu")["k"].shape[3] == 4
    check_pair(p, grads=False)
    base = pair("chatglm3-6b")
    bnp = batch_np(p.tcfg, 2, 16, 3)
    with torch.no_grad():
        a, _ = p.tapi.prefill(p.tparams, {"tokens": torch.from_numpy(
            bnp["tokens"])})
        b, _ = base.tapi.prefill(base.tparams, {"tokens": torch.from_numpy(
            bnp["tokens"])})
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-7b",
                                  "xlstm-350m", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("setting", [{"remat": False},
                                     {"remat_policy": "dots"},
                                     {"scan_layers": False}])
def test_remat_and_scan_layers_leave_the_gradients(arch, setting):
    """remat (both policies) and scan_layers change how the layers run,
    not what they compute: the same loss and gradients, bit for bit."""
    p = pair(arch)
    other = dataclasses.replace(p.tcfg, **setting)
    assert p.tcfg.remat and p.tcfg.scan_layers
    bnp = batch_np(p.tcfg, 2, 8, 5)
    tb = t_batch(bnp, p.tcfg)
    runs = [_value_and_grad(lambda q, b: get_model_api(cfg).loss_fn(q, b),
                            p.tparams, (tb,), False)
            for cfg in (p.tcfg, other)]
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[n], g2[n]) for n in g1)


def test_mesh_paths_wait_for_a6c(tmp_path):
    """The mesh paths on a one-rank gloo world's 1 × 1 mesh (ROADMAP
    A6c): granite-moe's loss (expert
    parallelism at ample capacity), prefill and a decode step equal the
    mesh-free ones, and the pspec trees come back."""
    import torch.distributed as dist
    from repro_torch.distributed import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    p = pair("granite-moe-3b-a800m")
    cfg = dataclasses.replace(p.tcfg, moe_capacity=8.0)
    api = get_model_api(cfg)
    tb = t_batch(batch_np(cfg, 2, 8, 0), cfg)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        mesh = make_test_mesh(1, 1)
        steps.set_mesh_for_alignment(mesh)
        specs = steps.align_pspecs(p.tparams, api.param_pspecs(mesh))
        dparams = steps.shard_tree(p.tparams, specs, mesh)
        db = steps.shard_tree(tb, steps.batch_pspecs(mesh, tb), mesh)
        assert sh.spec_leaves(api.cache_pspecs(mesh))
        loss = api.loss_fn(dparams, db, mesh).full_tensor()
        assert torch.allclose(loss, api.loss_fn(p.tparams, tb), atol=1e-5)
        with torch.no_grad():
            lg, cache = api.prefill(dparams, {"tokens": db["tokens"]}, mesh)
            lg0, cache0 = api.prefill(p.tparams, {"tokens": tb["tokens"]})
            assert torch.allclose(lg.full_tensor(), lg0, atol=1e-5)
            tok = {"token": tb["tokens"][:, :1]}
            d1, _ = api.decode_step(dparams, steps.shard_tree(
                tok, steps.batch_pspecs(mesh, tok), mesh), cache, 7, mesh)
            d0, _ = api.decode_step(p.tparams, tok, cache0, 7)
            assert torch.allclose(d1.full_tensor(), d0, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_params_from_jax_checks_the_tree():
    p = pair("qwen2-vl-2b")
    tree_np = to_numpy(p.jparams)
    bad = dict(tree_np, lm_head=tree_np["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(bad, p.tcfg, "cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in tree_np.items()
                         if k != "final_norm"}, p.tcfg, "cpu")
    wrong = dict(tree_np, final_norm=tree_np["final_norm"].astype(
        np.float64))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(wrong, p.tcfg, "cpu")
    got = params_from_jax(tree_np, p.tcfg, "cpu")
    assert all(torch.equal(a, torch.from_numpy(np.array(b)))
               for a, b in zip(tree.leaves(got), tree.leaves(tree_np)))
