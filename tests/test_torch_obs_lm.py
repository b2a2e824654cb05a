"""The LM path's spans and counters in ``repro_torch.obs`` (read through
``kernels.ops.counts()``): a greedy generation of the small latent-attention
model (tests/test_torch_lm_mla.py's) records ``lm.prefill`` once,
``lm.decode_step`` once a step, ``lm.mla`` once a layer a pass and
``lm.moe`` once an MoE layer a pass; the counters ``lm.moe_rows`` (the
(token, held expert) rows computed), ``lm.moe_tokens`` and
``lm.cache_bytes`` count
what the model did, tracing on or off, and tracing changes no token."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.serving.engine import greedy_generate
from test_torch_lm_mla import make, small_cfg

SPANS = ("lm.prefill", "lm.decode_step", "lm.mla", "lm.moe")
COUNTERS = ("lm.moe_rows", "lm.moe_tokens", "lm.cache_bytes")


@pytest.fixture
def tracing():
    obs.reset()
    obs.enable()
    try:
        yield
    finally:
        obs.enable(False)
        obs.reset()


def _generate(seed=0, max_new=5):
    cfg = small_cfg()
    api, params, tokens = make(cfg, seed=seed)
    prompt = tokens[:, :20].numpy().astype(np.int32)
    return cfg, api, params, greedy_generate(api, params, prompt, max_new,
                                             device="cpu")


def test_generation_records_each_span_and_counter(tracing, monkeypatch):
    seen = []
    real = moe.route

    def spy(*a, **k):
        w, idx = real(*a, **k)
        seen.append(idx)
        return w, idx

    monkeypatch.setattr(moe, "route", spy)
    cfg, _, _, out = _generate()
    c = ops.counts()
    passes = 1 + 4                       # the prefill and 4 decode steps
    assert c["span.lm.prefill.calls"] == 1
    assert c["span.lm.decode_step.calls"] == 4
    assert c["span.lm.mla.calls"] == cfg.n_layers * passes
    assert c["span.lm.moe.calls"] == cfg.n_moe_layers * passes
    for name in SPANS:
        assert c[f"span.{name}.ns"] > 0
    # the prefill and each step hold their layers' spans
    assert c["span.lm.prefill.self_ns"] < c["span.lm.prefill.ns"]
    # the prefill computes its held pairs; a decode step runs each of its
    # two tokens on all four held experts
    prefill = seen[:cfg.n_moe_layers]
    held = sum(int(((i >= cfg.experts_first)
                    & (i < cfg.experts_first + cfg.experts_held)).sum())
               for i in prefill)
    assert held > 0
    assert c["lm.moe_rows"] == held + 4 * cfg.n_moe_layers * 2 * \
        cfg.experts_held
    assert c["lm.moe_tokens"] == cfg.n_moe_layers * 2 * (20 + 4)
    # one latent cache of (L, B, 25) positions × (16 + 8) floats
    assert c["lm.cache_bytes"] == cfg.n_layers * 2 * 25 * (16 + 8) * 4


def test_counters_count_with_tracing_off_and_spans_do_not():
    obs.reset()
    _generate(seed=1, max_new=3)
    c = ops.counts()
    for name in SPANS:
        assert c[f"span.{name}.calls"] == 0
    for name in COUNTERS:
        assert c[name] > 0
    obs.reset()


def test_tracing_changes_no_token():
    obs.reset()
    *_, plain = _generate(seed=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        *_, traced = _generate(seed=2)
    assert np.array_equal(plain, traced)
    names = {e.key for e in prof.key_averages()}
    assert set(SPANS) <= names
    assert ops.counts()["span.lm.prefill.calls"] == 1
    obs.reset()
