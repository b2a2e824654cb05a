"""The LM zoo's building blocks in the port against the reference
(ROADMAP A6a), on the same numpy inputs: norms, SwiGLU, the four RoPE
variants, blockwise attention (both impls, tests/test_models_numerics.py's
chunk pairs and mask cases), the SSD and mLSTM scans with state, sLSTM,
Mamba2 decode against its own prefill, MoE routing, the loss, positions,
the decode cache's clamped write and the b-bit hashed embedding (its
codes bit for bit).  Tolerances are the reference tests' own: 2e-5 for
attention, 1e-4 for the scans, 1e-3 for decode against prefill; 1e-5
elsewhere (float32 ops in another order).  The reference's larger calls
run under ``jax.jit``: the same ops, compiled once."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import encdec as j_encdec
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.models import xlstm as j_xlstm

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, layers, moe, ssm, transformer, xlstm

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().to(torch.float32).numpy(),
        np.asarray(jnp.asarray(want, jnp.float32)), **(tol or TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_swiglu_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    ws = [rng.normal(size=s).astype(np.float32) * 0.3
          for s in ((16, 24), (16, 24), (24, 16))]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = jnp.dtype(dtype)
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    _close(layers.rmsnorm(_t(x).to(tdt), _t(scale).to(tdt), 1e-5),
           j_layers.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt)),
           **tol)
    _close(layers.swiglu(_t(x).to(tdt), *(_t(w).to(tdt) for w in ws)),
           j_layers.swiglu(jnp.asarray(x, jdt),
                           *(jnp.asarray(w, jdt) for w in ws)), **tol)


@pytest.mark.parametrize("variant,d,sections", [
    ("standard", 16, (16, 24, 24)), ("partial", 16, (16, 24, 24)),
    ("mrope", 16, (2, 3, 3)), ("none", 16, (16, 24, 24)),
    ("standard", 128, (16, 24, 24)), ("mrope", 128, (16, 24, 24))])
def test_rope_variants_match_reference(variant, d, sections):
    rng = np.random.default_rng(d)
    q = rng.normal(size=(2, 7, 4, d)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, d)).astype(np.float32)
    pos = (rng.integers(0, 600, size=(2, 7, 3)) if variant == "mrope"
           else rng.integers(0, 600, size=(2, 7))).astype(np.int32)
    kw = dict(variant=variant, theta=10000.0, mrope_sections=sections)
    gq, gk = layers.apply_rope(_t(q), _t(k), _t(pos), **kw)
    wq, wk = j_layers.apply_rope(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(pos), **kw)
    # angles up to 600 rad: float32 sin/cos of another library
    _close(gq, wq, rtol=1e-4, atol=1e-4)
    _close(gk, wk, rtol=1e-4, atol=1e-4)


def _naive_attention(q, k, v, causal=True, q_offset=0, kv_valid=None):
    """tests/test_models_numerics.py's reference softmax, in numpy."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    s = np.einsum("bqkgd,bskd->bkgqs", qg, k).reshape(
        b, h, sq, k.shape[1]) / np.sqrt(d)
    qpos = q_offset + np.arange(sq)
    kpos = np.arange(k.shape[1])
    mask = np.ones((sq, k.shape[1]), bool)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if kv_valid is not None:
        mask &= kpos[None, :] < kv_valid
    s = np.where(mask[None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    pg = p.reshape(b, kvh, h // kvh, sq, k.shape[1])
    return np.einsum("bkgqs,bskd->bqkgd", pg, v).reshape(b, sq, h, d)


@pytest.mark.parametrize("impl", ["loop", "scan"])
@pytest.mark.parametrize("qc,kc", [(8, 16), (16, 8), (64, 64)])
def test_blockwise_attention_matches_reference(impl, qc, kc):
    rng = np.random.default_rng(qc * 100 + kc)
    q = rng.normal(size=(2, 37, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, 53, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 53, 2, 16)).astype(np.float32)
    for causal, off, kvlen in [(True, 16, None), (False, 0, None),
                               (False, 0, 29)]:
        kw = dict(causal=causal, q_offset=off, kv_valid_len=kvlen,
                  q_chunk=qc, kv_chunk=kc, impl=impl)
        got = layers.blockwise_attention(_t(q), _t(k), _t(v), **kw)
        want = jax.jit(functools.partial(j_layers.blockwise_attention,
                                         **kw))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 2e-5
        naive = _naive_attention(q.astype(np.float64), k, v, causal, off,
                                 kvlen)
        assert float(np.abs(got.numpy() - naive).max()) < 2e-5


def test_blockwise_attention_gradient_matches_reference():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 21, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 21, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 21, 2, 8)).astype(np.float32)
    w = rng.normal(size=(2, 21, 4, 8)).astype(np.float32)
    kw = dict(causal=True, q_chunk=8, kv_chunk=8)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    (layers.blockwise_attention(tq, tk, tv, **kw) * _t(w)).sum().backward()
    want = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        j_layers.blockwise_attention(a, b, c, **kw) * w), argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, ref, rtol=1e-4, atol=1e-5)


def _ssd_inputs(seed=0, B=2, S=37, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, H, N, P)).astype(np.float32))


@pytest.mark.parametrize("chunk", [1, 8, 37, 64])
def test_ssd_chunked_matches_reference(chunk):
    args = _ssd_inputs()
    y, hf = ssm.ssd_chunked(*map(_t, args), chunk=chunk)
    wy, whf = jax.jit(functools.partial(j_ssm.ssd_chunked, chunk=chunk))(
        *map(jnp.asarray, args))
    _close(y, wy, rtol=0, atol=1e-4)
    _close(hf, whf, rtol=0, atol=1e-4)


def _mlstm_inputs(B=2, S=29, H=3, P=4):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, S, H, P)).astype(np.float32)
    k = (rng.normal(size=(B, S, H, P)) / np.sqrt(P)).astype(np.float32)
    v = rng.normal(size=(B, S, H, P)).astype(np.float32)
    ir = rng.normal(size=(B, S, H)).astype(np.float32)
    fr = (rng.normal(size=(B, S, H)) + 2).astype(np.float32)
    return q, k, v, ir, fr


@pytest.mark.parametrize("chunk", [1, 4, 29, 64])
def test_mlstm_core_matches_reference_with_state(chunk):
    args = _mlstm_inputs()
    got, (c, n, m) = xlstm._mlstm_core(*map(_t, args), None, chunk)
    want, (wc, wn, wm) = jax.jit(
        lambda *a: j_xlstm._mlstm_core(*a, None, chunk))(
        *map(jnp.asarray, args))
    _close(got, want, rtol=0, atol=1e-4)
    for a, b in ((c, wc), (n, wn), (m, wm)):
        _close(a, b, rtol=1e-4, atol=1e-4)
    # split-state continuation against one pass
    first = [a[:, :13] for a in args]
    rest = [a[:, 13:] for a in args]
    g1, st = xlstm._mlstm_core(*map(_t, first), None, 8)
    g2, _ = xlstm._mlstm_core(*map(_t, rest), st, 8)
    assert float(np.abs(torch.cat([g1, g2], 1).numpy()
                        - np.asarray(want)).max()) < 1e-4


def _mini_cfg(**kw):
    base = dict(name="t", family="hybrid", n_layers=1, d_model=32,
                n_heads=4, n_kv_heads=4, d_ff=64, vocab=100, ssm_state=8,
                ssm_head_dim=8, ssm_expand=2, dtype="float32")
    base.update(kw)
    return ArchConfig(**base), JArchConfig(**base)


def _carry(tree):
    return jax.tree.map(lambda a: _t(np.array(a)), tree)


def test_mamba2_forward_and_decode_match_reference():
    """tests/test_models_numerics.py::test_mamba2_prefill_decode_parity
    on the port, and its forward against the reference's."""
    cfg, jcfg = _mini_cfg()
    jparams = j_ssm.init_mamba2_params(jcfg, jax.random.key(0), jnp.float32)
    params = _carry(jparams)
    x = np.random.default_rng(2).normal(size=(2, 13, 32)).astype(np.float32)
    y_all, (hT, convT) = ssm.mamba2_forward(params, _t(x), cfg, chunk=4)
    wy, (whT, wconv) = j_ssm.mamba2_forward(jparams, jnp.asarray(x), jcfg,
                                            chunk=4)
    _close(y_all, wy, rtol=1e-4, atol=1e-5)
    _close(hT, whT, rtol=1e-4, atol=1e-5)
    _close(convT, wconv)
    st = (torch.zeros((2, 8, 8, 8)), torch.zeros((2, 3, 80)))
    ys = []
    for t in range(13):
        y1, st = ssm.mamba2_decode_step(params, _t(x[:, t:t + 1]), cfg, st)
        ys.append(y1)
    assert float((y_all - torch.cat(ys, 1)).abs().max()) < 1e-3
    assert float((hT - st[0]).abs().max()) < 1e-3


def test_slstm_and_mlstm_forward_match_reference():
    cfg, jcfg = _mini_cfg(family="ssm", n_heads=4)
    key = jax.random.key(3)
    x = np.random.default_rng(3).normal(size=(2, 11, 32)).astype(np.float32)
    for j_init, j_fwd, fwd, kw in (
            (j_xlstm.init_slstm_params, j_xlstm.slstm_forward,
             xlstm.slstm_forward, {}),
            (j_xlstm.init_mlstm_params, j_xlstm.mlstm_forward,
             xlstm.mlstm_forward, {"chunk": 4})):
        jp = j_init(jcfg, key, jnp.float32)
        y, st = fwd(_carry(jp), _t(x), cfg, **kw)
        wy, wst = jax.jit(lambda q, a: j_fwd(q, a, jcfg, **kw))(
            jp, jnp.asarray(x))
        _close(y, wy, rtol=1e-4, atol=1e-5)
        for a, b in zip(st, wst):
            _close(a, b, rtol=1e-4, atol=1e-4)


def test_moe_routing_and_ffn_match_reference():
    cfg, jcfg = _mini_cfg(family="moe", moe_experts=8, moe_top_k=2,
                          moe_d_ff=16, n_shared_experts=1)
    assert moe.padded_experts(cfg) == j_moe.padded_experts(jcfg) == 16
    jp = j_moe.init_moe_params(jcfg, jax.random.key(4), jnp.float32)
    x = np.random.default_rng(4).normal(size=(3, 5, 32)).astype(np.float32)
    gates, idx = moe._routing(_t(x.reshape(15, 32)), _t(np.asarray(
        jp["router"])), 2)
    wg, widx = j_moe._routing(jnp.asarray(x.reshape(15, 32)), jp["router"],
                              2)
    assert np.array_equal(np.sort(idx.numpy(), 1), np.sort(np.asarray(
        widx), 1))
    _close(gates.sort(1).values, jnp.sort(wg, 1))
    _close(moe.moe_ffn(_t(x), _carry(jp), cfg),
           jax.jit(lambda a, q: j_moe.moe_ffn(a, q, jcfg))(jnp.asarray(x),
                                                           jp),
           rtol=1e-5, atol=1e-6)


def test_xent_loss_and_positions_match_reference():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 9, 50)).astype(np.float32) * 4
    tg = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    _close(transformer.xent_loss(_t(logits), _t(tg)),
           j_tf.xent_loss(jnp.asarray(logits), jnp.asarray(tg)))
    cfg, jcfg = _mini_cfg(family="vlm", rope_variant="mrope",
                          frontend="vision_stub", frontend_len=9)
    for seq, off in ((12, 0), (1, 10), (1, 3)):
        assert np.array_equal(
            transformer.build_positions(cfg, 2, seq, offset=off).numpy(),
            np.asarray(j_tf.build_positions(jcfg, 2, seq, offset=off)))
    _close(encdec.sinusoidal(7, 16, offset=5),
           j_encdec.sinusoidal(7, 16, offset=5))


def test_cache_write_clamps_like_dynamic_update_slice():
    """The decode write lands at cache_len (a negative one from the end),
    clamped into [0, max_len - s] as jax.lax.dynamic_update_slice_in_dim
    places it: at max_len - 1 one position fits; past it the write moves
    back."""
    max_len = 6
    cache = np.zeros((1, max_len, 1, 1), np.float32)
    for start, s in ((0, 1), (5, 1), (6, 1), (9, 1), (4, 2), (5, 2),
                     (-2, 1), (-9, 1)):
        upd = np.arange(1, s + 1, dtype=np.float32).reshape(1, s, 1, 1)
        want = np.asarray(jax.lax.dynamic_update_slice_in_dim(
            jnp.asarray(cache), jnp.asarray(upd), start, axis=1))
        got = torch.zeros(cache.shape)
        at = transformer.cache_write_start(start, max_len, s)
        got[:, at:at + s] = _t(upd)
        assert np.array_equal(got.numpy(), want), (start, s)
    assert transformer.cache_write_start(max_len - 1, max_len, 1) == \
        max_len - 1


@pytest.mark.parametrize("hash_k,hash_b", [(8, 12), (4, 8), (3, 16)])
def test_hashed_embedding_codes_bitwise_and_lookup(hash_k, hash_b):
    """A table whose row c of table j holds c at column j turns the
    lookup into the codes (times 1/sqrt(k)): both packages' codes are
    recovered exactly and equal the port's hashed_embed_codes."""
    rng = np.random.default_rng(hash_b)
    tokens = np.concatenate([
        rng.integers(0, 1 << 31, size=200), [0, 1, 92543, 2**31 - 1],
    ]).astype(np.int32).reshape(2, 102)
    codes = layers.hashed_embed_codes(_t(tokens), hash_k, hash_b).numpy()
    tab = np.zeros((hash_k, 1 << hash_b, hash_k), np.float32)
    for j in range(hash_k):
        tab[j, :, j] = np.arange(1 << hash_b)
    scale = np.sqrt(np.float32(hash_k))
    for lookup in (
            lambda: layers.hashed_embed_lookup(
                {"hash_tables": _t(tab)}, _t(tokens), hash_k,
                hash_b).numpy(),
            lambda: np.asarray(j_layers.hashed_embed_lookup(
                {"hash_tables": jnp.asarray(tab)}, jnp.asarray(tokens),
                hash_k, hash_b))):
        rec = np.rint(lookup().astype(np.float64) * scale).astype(np.int64)
        assert np.array_equal(rec, codes)
    assert codes.max() < 1 << hash_b and len(np.unique(codes)) > 50
    # a random table, float32 and bfloat16
    table = rng.normal(size=(hash_k, 1 << hash_b, 16)).astype(np.float32)
    for tdt, jdt, tol in ((torch.float32, jnp.float32, TOL),
                          (torch.bfloat16, jnp.bfloat16,
                           dict(rtol=0, atol=0))):
        _close(layers.hashed_embed_lookup(
            {"hash_tables": _t(table).to(tdt)}, _t(tokens), hash_k, hash_b),
            j_layers.hashed_embed_lookup(
                {"hash_tables": jnp.asarray(table, jdt)},
                jnp.asarray(tokens), hash_k, hash_b), **tol)
