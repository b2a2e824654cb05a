"""Kimi-K2-Instruct's decode on the card: the step that ``mla_decode_step``
captures as a CUDA graph at a generation's first step and replays after,
against the same step run eagerly (``_mla_decode_body``) and against the
plain float32 reference (tests/_kimi_k2_ref.py), at the small size of
tests/test_torch_lm_mla.py, in bfloat16 (the prefill's fused attention
on the card takes bfloat16 or float16).  Every test needs an NVIDIA GPU and skips
without one; nothing of JAX is imported:

    python -m pytest -q -m cuda tests/test_torch_lm_mla_cuda.py

A replay and the eager step compute the same kernels on the same inputs,
so their logits and caches are equal bit for bit; against the reference,
the bfloat16 tolerance of test_torch_lm_mla.py (median position 5 %).
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import _kimi_k2_ref as ref
from repro_torch.models import moe
from repro_torch.models import transformer as tf_lib
from repro_torch.serving.engine import greedy_generate, grow_cache
from test_torch_lm_mla import assert_close, make, small_cfg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@torch.no_grad()
def _eager(api, params, cfg, tok, s0, dev):
    """The eager step teacher-forced by ``tok`` (B, S) on the card →
    (logits (B, S − s0, V) at positions s0 − 1 … S − 2, the cache)."""
    b, total = tok.shape
    logits, cache = api.prefill(params, {"tokens": tok[:, :s0]})
    cache = grow_cache(api.init_cache(b, total, device=dev), cache)
    got = [logits]
    for t in range(s0, total - 1):
        pos = torch.full((1,), t, dtype=torch.int64, device=dev)
        got.append(tf_lib._mla_decode_body(
            params, tok[:, t:t + 1], pos, cache, cfg))
    return torch.stack(got, 1), cache


@torch.no_grad()
def test_replayed_steps_equal_eager_steps_and_the_reference(dev):
    cfg = small_cfg(dtype="bfloat16")
    api, params, tokens = make(cfg, seed=7, bias_std=0.3)
    params = _on(params, dev)
    tok = tokens.to(dev).int()
    decoder = tf_lib.MLADecoder(cfg)
    logits, cache = api.prefill(params, {"tokens": tok[:, :30]})
    cache = grow_cache(api.init_cache(2, 40, device=dev), cache)
    got, graphs = [logits], set()
    rows = moe.MOE_ROWS.value
    for t in range(30, 39):
        logits, cache = decoder(params, tok[:, t:t + 1], cache, t)
        graphs.add(id(cache.graph))
        got.append(logits.clone())
    g_rows = moe.MOE_ROWS.value - rows
    g_logits = torch.stack(got, 1)
    # one graph, captured at the first step, whose cache the steps carry
    assert len(graphs) == 1 and len(decoder.graphs) == 1
    e_logits, e_cache = _eager(api, params, cfg, tok, 30, dev)
    assert torch.equal(g_logits, e_logits)
    for name in ("c_kv", "k_rope"):
        assert torch.equal(cache[name], e_cache[name])
    assert g_rows == 9 * cfg.n_moe_layers * 2 * cfg.experts_held
    want, _ = ref.forward(_on(params, torch.device("cpu")), tokens,
                          ref.hp_of(cfg), range(29, 39))
    assert_close(g_logits.cpu(), want, "bfloat16")


def test_greedy_generate_replays_the_same_tokens_call_after_call(
        dev, monkeypatch):
    """The second call replays the graph the first captured, its cache
    copied in: both give the same tokens, and each new token is the argmax
    of the eager step fed the tokens before it."""
    captures = []

    class Counted(tf_lib._DecodeGraph):
        def __init__(self, *a, **k):
            captures.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(tf_lib, "_DecodeGraph", Counted)
    cfg = small_cfg(dtype="bfloat16")
    api, params, tokens = make(cfg, seed=8)
    params = _on(params, dev)
    prompt = tokens[:, :24].numpy().astype(np.int32)
    first = greedy_generate(api, params, prompt, 8, device=dev)
    again = greedy_generate(api, params, prompt, 8, device=dev)
    assert len(captures) == 1
    assert np.array_equal(first, again)
    assert np.array_equal(first[:, :24], prompt)
    tok = torch.from_numpy(first).to(dev)
    picked = _eager(api, params, cfg, tok, 24, dev)[0].argmax(-1)
    assert torch.equal(picked.cpu(), torch.from_numpy(first[:, 24:]).long())


@torch.no_grad()
def test_a_decoder_serves_one_generation_a_shape_and_drops_params(dev):
    """A step of a generation whose graph a later generation of its shape
    has taken raises; params the caller drops are not kept alive."""
    cfg = small_cfg(dtype="bfloat16")
    api, params, tokens = make(cfg, seed=10)
    params = _on(params, dev)
    tok = tokens.to(dev).int()
    decoder = tf_lib.MLADecoder(cfg)
    caches = []
    for _ in range(2):
        _, cache = api.prefill(params, {"tokens": tok[:, :20]})
        cache = grow_cache(api.init_cache(2, 24, device=dev), cache)
        caches.append(decoder(params, tok[:, 20:21], cache, 20)[1])
    decoder(params, tok[:, 21:22], caches[1], 21)
    with pytest.raises(RuntimeError, match="one generation at a time"):
        decoder(params, tok[:, 21:22], caches[0], 21)
    leaf = weakref.ref(params["lm_head"])
    del params, caches, cache
    gc.collect()
    assert leaf() is None


def test_greedy_generate_of_more_prompts_than_held_experts(dev):
    """A batch of experts_held + 1 prompts: every decode step runs each
    held expert on all its tokens, so the step is captured with no
    read-back at any batch; its tokens are the eager step's argmax, and
    the logits match the reference's."""
    cfg = small_cfg(dtype="bfloat16")
    api, params, _ = make(cfg, seed=9, bias_std=0.3)
    b = cfg.experts_held + 1
    g = torch.Generator().manual_seed(9)
    prompt = torch.randint(0, cfg.vocab, (b, 20), generator=g)
    params = _on(params, dev)
    out = greedy_generate(api, params, prompt.numpy().astype(np.int32), 8,
                          device=dev)
    assert out.shape == (b, 28)
    assert np.array_equal(out[:, :20], prompt.numpy())
    tok = torch.from_numpy(out).to(dev)
    eager, _ = _eager(api, params, cfg, tok, 20, dev)
    assert torch.equal(eager.argmax(-1).cpu(),
                       torch.from_numpy(out[:, 20:]).long())
    want, _ = ref.forward(_on(params, torch.device("cpu")),
                          torch.from_numpy(out[:, :27]).long(),
                          ref.hp_of(cfg), range(19, 27))
    assert_close(eager.cpu(), want, "bfloat16")
