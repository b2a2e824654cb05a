"""Kimi-K2-Instruct's mechanisms in the port (configs/kimi_k2_instruct.py):
multi-head latent attention with YaRN, the leading dense layer and the
held-expert MoE layer, against the plain float32 reference
(tests/_kimi_k2_ref.py) on seeded random weights at a small size: d_model
64, 4 heads, ranks 32/16, rope 8, nope 16, v 16, 16 experts of which 4
held, top-4, one shared, one dense and two MoE layers, vocab 256.

Tolerances: in float32 the program and the reference compute the same
sums in other orders (SDPA and the absorbed decode against explicit
softmax(q·k)·v, the held pairs by expert against by mask), so logits of
magnitude ~4 agree to 1e-4 of the largest (a few hundred float32 ulps
through three layers).  In bfloat16 a position's logits agree to about
1.5–2.7 % (relative L2; each of the ~20 roundings a layer is 2^-9
relative and the residual is summed in bfloat16), except where rounding
flips a near-tied routing choice onto or off a held expert, which moves
that position by up to ~60 %; so the median over positions is held to
5 %: a missing or doubled term moves every position by the order of its
size.
"""
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import _kimi_k2_ref as ref
from repro_torch.configs import archs, get_config, list_configs
from repro_torch.configs.base import MLAConfig
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf_lib
from repro_torch.models.api import get_model_api
from repro_torch.serving.engine import greedy_generate, grow_cache

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4
BF16_TOL = 0.05


def assert_close(got, want, dtype):
    """(…, V) logits: float32 elementwise to F32_TOL of the largest;
    bfloat16 the median position's relative L2 error to BF16_TOL."""
    got, want = got.float(), want.float()
    if dtype == "float32":
        assert (got - want).abs().max() <= F32_TOL * want.abs().max()
    else:
        per = (got - want).norm(dim=-1) / want.norm(dim=-1)
        assert per.flatten().median() <= BF16_TOL, per


def small_cfg(**kw) -> MLAConfig:
    base = dict(
        name="mla-test", family="moe", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=24, d_ff=96, vocab=256, moe_experts=16,
        moe_top_k=4, moe_d_ff=32, n_shared_experts=1, rope_variant="yarn",
        rope_theta=50000.0, norm_eps=1e-6, remat=False, dtype="float32",
        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, first_k_dense=1,
        moe_routed_scale=2.827, rope_factor=32.0, rope_original_max_pos=16,
        rope_beta_fast=1.0, rope_beta_slow=1.0, rope_mscale=1.0,
        rope_mscale_all_dim=1.0, experts_held=4, experts_first=4)
    base.update(kw)
    return MLAConfig(**base)


def make(cfg, seed=0, bias_std=None):
    api = get_model_api(cfg)
    g = torch.Generator().manual_seed(seed)
    params = api.init_params(g, device="cpu")
    if bias_std is not None:
        # a bias large enough to change the choice at most tokens
        rb = params["layers"]["moe"]["router_bias"]
        rb.copy_(torch.randn(rb.shape, generator=g) * bias_std)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=g)
    return api, params, tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_reference(dtype):
    cfg = small_cfg(dtype=dtype)
    api, params, tokens = make(cfg, bias_std=0.3)
    want, _ = ref.forward(params, tokens, ref.hp_of(cfg), range(40))
    assert_close(tf_lib.mla_forward_train(params, tokens, cfg), want, dtype)
    got_last, cache = api.prefill(params, {"tokens": tokens.int()})
    if dtype == "float32":
        assert_close(got_last, want[:, -1], dtype)
    assert set(cache) == {"c_kv", "k_rope"}
    assert cache["c_kv"].shape == (3, 2, 40, 16)
    assert cache["k_rope"].shape == (3, 2, 40, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_full_forward(dtype):
    """Prefill of 30 tokens, the cache grown to 40, then 9 decode steps
    fed the reference's tokens (teacher forcing): each step's logits
    against the full forward pass at that position."""
    cfg = small_cfg(dtype=dtype)
    api, params, tokens = make(cfg, seed=1, bias_std=0.3)
    want, _ = ref.forward(params, tokens, ref.hp_of(cfg), range(29, 39))
    logits, cache = api.prefill(params, {"tokens": tokens[:, :30].int()})
    cache = grow_cache(api.init_cache(2, 40, device="cpu"), cache)
    got = [logits]
    for t in range(30, 39):
        logits, cache = api.decode_step(
            params, {"token": tokens[:, t:t + 1].int()}, cache, t)
        got.append(logits)
    assert_close(torch.stack(got, dim=1), want, dtype)
    # the latent cache holds what a prefill of all 39 tokens computes (in
    # bfloat16 layer 0's, which no routing choice upstream can move)
    _, full = api.prefill(params, {"tokens": tokens[:, :39].int()})
    layers_, tol = (slice(None), 1e-5) if dtype == "float32" else (
        slice(0, 1), 0.02)
    for name in ("c_kv", "k_rope"):
        c = cache[name][layers_, :, :39].float()
        assert (c - full[name][layers_].float()).abs().max() <= \
            tol * c.abs().max()
        assert not cache[name][:, :, 39:].any()


def test_greedy_generate_runs_the_latent_cache():
    cfg = small_cfg()
    api, params, tokens = make(cfg, seed=2)
    prompt = tokens[:, :24].numpy().astype(np.int32)
    out = greedy_generate(api, params, prompt, 6, device="cpu")
    assert out.shape == (2, 30)
    assert (out[:, :24] == prompt).all()
    # each new token is the argmax of the reference fed the tokens before
    want, _ = ref.forward(params, torch.from_numpy(out).long(),
                          ref.hp_of(cfg), range(23, 29))
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3     # no near-tie
    picked = torch.from_numpy(out[:, 24:30]).long()
    agree = want.argmax(-1) == picked
    assert agree[clear].all()


def test_route_sigmoid_bias_selects_normalised_scaled():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(32, 8, generator=g)
    router = torch.randn(8, 16, generator=g)
    bias = torch.randn(16, generator=g)
    w, idx = moe.route(x, router, bias, 4, 2.827)
    scores = torch.sigmoid(x @ router)
    want_idx = torch.topk(scores + bias, 4, dim=-1).indices
    assert torch.equal(torch.sort(idx).values, torch.sort(want_idx).values)
    # the bias picks: without it other experts win at some tokens
    plain = torch.topk(scores, 4, dim=-1).indices
    assert not torch.equal(torch.sort(idx).values, torch.sort(plain).values)
    # ... and does not weigh: the weights are the chosen sigmoid scores,
    # normalised to sum 1, times the routed scale
    sel = torch.gather(scores, 1, idx)
    assert torch.allclose(w, sel / sel.sum(-1, keepdim=True) * 2.827,
                          rtol=1e-6, atol=0)
    assert torch.allclose(w.sum(-1), torch.full((32,), 2.827), rtol=1e-6)
    rw, ridx = ref.route(x, router, bias, {"top_k": 4, "routed_scale": 2.827},
                         False)
    assert torch.equal(ridx, idx) and torch.allclose(rw, w, rtol=1e-6)


def test_yarn_frequencies_and_mscale():
    cfg = get_config("kimi-k2-instruct-ep32")
    inv = layers.yarn_inv_freq(64, 50000.0, 32.0, 4096, 1.0, 1.0)
    plain = 1.0 / 50000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32)
                              / 64)
    # the correction range: dim 64·ln(4096/2π)/(2·ln 50000) = 19.17, so
    # pairs 0–19 turn more than once over 4,096 positions and keep their
    # frequency; pairs 20–31 are divided by the factor
    assert torch.allclose(inv[:20], plain[:20], rtol=1e-6, atol=0)
    assert torch.allclose(inv[20:], plain[20:] / 32.0, rtol=1e-6, atol=0)
    want = ref.yarn_inv_freq(64, ref.hp_of(cfg))
    assert torch.allclose(inv.double(), want, rtol=1e-6, atol=0)
    m = 0.1 * math.log(32.0) + 1.0
    assert layers.yarn_mscale(32.0, 1.0) == pytest.approx(m, rel=1e-12)
    assert layers.yarn_mscale(1.0, 1.0) == 1.0
    assert tf_lib.mla_softmax_scale(cfg) == pytest.approx(
        192 ** -0.5 * m * m, rel=1e-12)
    assert ref.softmax_scale(ref.hp_of(cfg)) == pytest.approx(
        tf_lib.mla_softmax_scale(cfg), rel=1e-12)
    # applied: the rotation at position p is p·inv, times mscale ratio 1
    q = torch.randn(1, 3, 2, 64)
    k = torch.randn(1, 3, 1, 64)
    pos = torch.tensor([[0, 5, 4000]])   # float32 angles: 4000·2^-24 rad
    rot = layers.yarn_rotation(pos, 64, 50000.0,
                               (32.0, 4096, 1.0, 1.0, 1.0, 1.0))
    gq, gk = layers.apply_rotation(q, rot), layers.apply_rotation(k, rot)
    hp = ref.hp_of(cfg)
    assert torch.allclose(gq[0], ref.rope(q[0], pos[0], hp), atol=1e-3)
    assert torch.allclose(gk[0], ref.rope(k[0], pos[0], hp), atol=1e-3)
    assert torch.equal(gq[0, 0], q[0, 0])
    # an mscale apart from mscale_all_dim scales the rotated vectors
    rot2 = layers.yarn_rotation(pos, 64, 50000.0,
                                (32.0, 4096, 1.0, 1.0, 2.0, 1.0))
    m2 = layers.yarn_mscale(32.0, 2.0) / layers.yarn_mscale(32.0, 1.0)
    assert torch.allclose(rot2[0], rot[0] * m2, rtol=1e-6)
    assert torch.allclose(layers.apply_rotation(q, rot2), gq * m2,
                          atol=1e-5)
    hp2 = dict(hp, rope_mscale=2.0)
    assert torch.allclose(layers.apply_rotation(q, rot2)[0],
                          ref.rope(q[0], pos[0], hp2), atol=2e-3)


@pytest.mark.parametrize("shape,decode", [((2, 24), False),
                                          ((13, 1), True)],
                         ids=["grouped", "decode"])
def test_held_blocks_add_up_to_the_uncut_layer(shape, decode):
    """Four cards each hold 4 of the 16 experts: their partial MoE
    outputs, with the shared expert (which every card computes) counted
    once, add up to the reference's layer with all 16 experts.  A prefill
    of 48 tokens takes the grouped pairs; a decode step of 13 tokens, more
    than the 4 held experts, runs every held expert on all of them."""
    cfg = small_cfg()
    full = small_cfg(experts_held=16, experts_first=0)
    g = torch.Generator().manual_seed(4)
    init = layers.ParamInit(g, torch.device("cpu"))
    mp = moe.init_held_moe_params(full, init, torch.float32)
    mp["router_bias"] = torch.randn(16, generator=g) * 0.3
    x = torch.randn(*shape, 64, generator=g)
    shared = mp["shared"]
    parts = []
    for first in (0, 4, 8, 12):
        held = dict(mp, **{n: mp[n][first:first + 4]
                           for n in ("w_gate", "w_up", "w_down")})
        part = moe.held_moe_ffn(x, held, dataclasses.replace(
            cfg, experts_first=first), decode=decode)
        parts.append(part)
    shared_out = ref.swiglu(x.reshape(-1, 64), shared["w_gate"],
                            shared["w_up"], shared["w_down"], False)
    total = sum(parts).reshape(-1, 64) - 3 * shared_out
    want, idx = ref.moe(x.reshape(-1, 64), mp, ref.hp_of(full), False)
    assert torch.allclose(total, want, atol=1e-5, rtol=0)
    assert idx.shape == (shape[0] * shape[1], 4)


def test_held_layer_counts_its_pairs_and_runs_no_dense_fallback(
        monkeypatch):
    cfg = small_cfg()
    api, params, tokens = make(cfg, seed=5)

    def never(*a, **k):
        raise AssertionError("the dense fallback ran")

    monkeypatch.setattr(moe, "_dense_fallback", never)
    monkeypatch.setattr(tf_lib, "blockwise_attention", never)
    before = moe.MOE_ROWS.value, moe.MOE_TOKENS.value
    seen = []
    real = moe.route

    def spy(*a, **k):
        w, idx = real(*a, **k)
        seen.append(idx)
        return w, idx

    monkeypatch.setattr(moe, "route", spy)
    api.prefill(params, {"tokens": tokens.int()})
    held = sum(int(((i >= 4) & (i < 8)).sum()) for i in seen)
    assert moe.MOE_ROWS.value - before[0] == held
    assert moe.MOE_TOKENS.value - before[1] == 2 * 80


def test_mesh_is_refused():
    cfg = small_cfg()
    api, params, tokens = make(cfg, seed=6)
    with pytest.raises(ValueError, match="no mesh path"):
        api.prefill(params, {"tokens": tokens.int()}, mesh=object())
    with pytest.raises(ValueError, match="no mesh path"):
        api.param_pspecs(object())


def test_the_config_is_the_published_model_cut_to_one_card():
    cfg = get_config("kimi-k2-instruct-ep32")
    assert isinstance(cfg, MLAConfig)
    assert "kimi-k2-instruct-ep32" not in list_configs()
    assert "kimi-k2-instruct-ep32" not in archs.ALL_ARCHS
    assert (cfg.n_layers, cfg.first_k_dense, cfg.d_model, cfg.n_heads,
            cfg.vocab) == (9, 1, 7168, 64, 163840)
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim) == (1536, 512, 128, 64, 128)
    assert (cfg.moe_experts, cfg.moe_top_k, cfg.experts_held,
            cfg.experts_first, cfg.moe_d_ff, cfg.d_ff,
            cfg.n_shared_experts) == (384, 8, 12, 0, 2048, 18432, 1)
    assert cfg.moe_routed_scale == 2.827 and cfg.norm_eps == 1e-6
    assert (cfg.rope_theta, cfg.rope_factor, cfg.rope_original_max_pos,
            cfg.rope_beta_fast, cfg.rope_beta_slow, cfg.rope_mscale,
            cfg.rope_mscale_all_dim) == (50000.0, 32.0, 4096, 1.0, 1.0,
                                         1.0, 1.0)
    # 0.995 GB (dense layer) + 8 × 1.353 GB + 4.70 GB in bfloat16
    assert cfg.mla_params() == 101_138_432
    assert cfg.n_params() * 2 == pytest.approx(16.5e9, rel=0.01)
    # the param tree of the cut model, shaped on the meta device
    tree = get_model_api(cfg).init_params(None, device="meta")
    assert tree["layers"]["moe"]["w_gate"].shape == (8, 12, 7168, 2048)
    assert tree["layers"]["moe"]["router"].shape == (8, 7168, 384)
    assert tree["dense_layers"]["mlp"]["w_up"].shape == (1, 7168, 18432)
    assert tree["layers"]["wkv_b"].shape == (8, 512, 64 * 256)


def test_latent_cache_is_a_third_of_the_gqa_cache():
    cfg = get_config("kimi-k2-instruct-ep32")
    c = tf_lib.init_mla_cache(cfg, 1, 4, device="meta")
    per_token_layer = sum(t.shape[-1] * t.element_size()
                          for t in c.values())
    assert per_token_layer == 1152            # (512 + 64) × 2 bytes
    gqa = get_config("kimi-k2-1t-a32b")
    assert 2 * gqa.n_kv_heads * gqa.head_dim * 2 == 3584


def test_the_benchmark_reference_is_this_reference():
    bench = ROOT / "hashbench" / "reference" / "kimi_k2.py"
    assert bench.read_text() == (ROOT / "tests" / "_kimi_k2_ref.py").read_text()
