"""The LM zoo (ROADMAP A6a) on the card against the port on the CPU.
Every test needs an NVIDIA GPU and skips without one; the file imports
nothing of JAX, so it runs where only torch is installed:

    python -m pytest -q -m cuda tests/test_torch_lm_cuda.py

Each architecture at ``reduced_config`` in float32, on the same params
and inputs, under ``full_float32_matmul`` (no TF32): the loss (1e-5
relative), its gradients (1e-4 of each leaf's largest), prefill's logits
and cache, one decode step (1e-4 absolute: the CPU parity tests'
tolerances), ``greedy_generate``'s tokens (equal, or parted where the
CPU's top-2 margin is within twice the logits' tolerance); the hashed
embedding's codes on the card bit for bit; a decode write at the
cache's last slot; the microbatched step; bfloat16 decode against its
own prefill.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.launch.smoke_configs import reduced_config
from repro_torch.models.api import get_model_api
from repro_torch.models.layers import hashed_embed_codes
from repro_torch.models.linear import full_float32_matmul
from repro_torch.optim.optimizers import AdamWConfig, adamw
from repro_torch.serving import greedy_generate
from repro_torch.serving.engine import grow_cache
from repro_torch.train.steps import (_value_and_grad,
                                     build_microbatched_train_step,
                                     init_state)

pytestmark = pytest.mark.cuda

LOGIT_ATOL, LOSS_RTOL, GRAD_REL = 1e-4, 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _batch(cfg, batch, seq, seed):
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
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _setup(arch, dev, **changes):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    api = get_model_api(cfg)
    p_cpu = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    return cfg, api, p_cpu, tree.tree_map(lambda t: t.to(dev), p_cpu)


def _grown(api, cache, b, max_len, dev):
    return grow_cache(api.init_cache(b, max_len, device=dev), cache)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_reduced_arch_card_matches_cpu(cuda, arch):
    cfg, api, p_cpu, p_dev = _setup(arch, cuda)
    b_cpu = _batch(cfg, 2, 16, 3)
    b_dev = {k: v.to(cuda) for k, v in b_cpu.items()}
    runs = []
    with full_float32_matmul():
        for params, batch, dev in ((p_cpu, b_cpu, "cpu"),
                                   (p_dev, b_dev, cuda)):
            loss, grads = _value_and_grad(lambda p, b: api.loss_fn(p, b),
                                          params, (batch,), False)
            pre = {k: v for k, v in batch.items() if k != "targets"}
            with torch.no_grad():
                logits, cache = api.prefill(params, pre)
                cache_l = [t.cpu() for t in tree.leaves(cache)]
                dec, _ = api.decode_step(
                    params, {"token": batch["tokens"][:, :1]},
                    _grown(api, cache, 2, 20, dev), 16)
            runs.append((float(loss), {n: g.cpu() for n, g in grads.items()},
                         logits.cpu(), cache_l, dec.cpu()))
    (l_c, g_c, lg_c, c_c, d_c), (l_d, g_d, lg_d, c_d, d_d) = runs
    assert abs(l_d - l_c) <= LOSS_RTOL * abs(l_c)
    for n in g_c:
        if g_c[n].numel():
            scale = max(float(g_c[n].abs().max()), 1e-3)
            assert float((g_d[n] - g_c[n]).abs().max()) <= \
                GRAD_REL * scale, n
    for a, b in [(lg_d, lg_c), (d_d, d_c)] + list(zip(c_d, c_c)):
        assert float((a - b).abs().max()) <= LOGIT_ATOL


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "kimi-k2-1t-a32b",
                                  "qwen2-vl-2b", "zamba2-7b", "xlstm-350m",
                                  "seamless-m4t-large-v2"])
def test_greedy_generate_card_matches_cpu(cuda, arch):
    cfg, api, p_cpu, p_dev = _setup(arch, cuda)
    batch = _batch(cfg, 2, 12, 7)
    extras = {k: v for k, v in batch.items()
              if k not in ("tokens", "targets")}
    prompt = batch["tokens"].numpy()
    with full_float32_matmul():
        got = greedy_generate(api, p_dev, prompt, 8,
                              extras={k: v.to(cuda)
                                      for k, v in extras.items()},
                              device=cuda)
        want = greedy_generate(api, p_cpu, prompt, 8, extras=extras,
                               device="cpu")
    diff = np.argwhere(got != want)
    if len(diff):                      # parted: only at a tie of the CPU's
        pos = int(diff[:, 1].min())
        rows = sorted({int(r) for r, c in diff if c == pos})
        with torch.no_grad():
            lg, _ = api.prefill(p_cpu, dict(extras, tokens=torch.from_numpy(
                want[:, :pos])))
        top = torch.topk(lg[rows], 2, dim=-1).values
        assert float((top[:, 0] - top[:, 1]).max()) <= 2 * LOGIT_ATOL


def test_hashed_codes_and_embedding_on_the_card(cuda):
    tokens = torch.randint(0, 1 << 31, (4, 256), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    for k, b in ((8, 12), (3, 16)):
        assert torch.equal(hashed_embed_codes(tokens.to(cuda), k, b).cpu(),
                           hashed_embed_codes(tokens, k, b))
    cfg, api, p_cpu, p_dev = _setup("internlm2-1.8b", cuda,
                                    embedding="bbit_hash", hash_b=8)
    batch = _batch(cfg, 2, 16, 4)
    with torch.no_grad(), full_float32_matmul():
        a = api.loss_fn(p_cpu, batch)
        b = api.loss_fn(p_dev, {k: v.to(cuda) for k, v in batch.items()})
    assert abs(float(b) - float(a)) <= LOSS_RTOL * abs(float(a))


def test_decode_at_the_last_cache_slot_on_the_card(cuda):
    cfg, api, p_cpu, p_dev = _setup("internlm2-1.8b", cuda)
    max_len = 10
    tokens = _batch(cfg, 2, max_len - 1, 2)["tokens"]
    outs = []
    with torch.no_grad(), full_float32_matmul():
        for params, dev in ((p_cpu, "cpu"), (p_dev, cuda)):
            _, cache = api.prefill(params, {"tokens": tokens.to(dev)})
            cache = _grown(api, cache, 2, max_len, dev)
            dec, cache = api.decode_step(
                params, {"token": tokens[:, -1:].to(dev)}, cache,
                max_len - 1)
            outs.append((dec.cpu(), cache["k"][:, :, max_len - 1].cpu()))
    assert float((outs[1][0] - outs[0][0]).abs().max()) <= LOGIT_ATOL
    assert float((outs[1][1] - outs[0][1]).abs().max()) <= LOGIT_ATOL
    assert float(outs[1][1].abs().sum()) > 0


def test_microbatched_step_card_matches_cpu(cuda):
    """Three AdamW steps at n_micro=2 (eps 1e-4: at 1e-8 a gradient at
    float32 noise level becomes a full step of the rounding's sign,
    tests/test_torch_lm_generate.py) within 1e-5."""
    cfg, api, p_cpu, _ = _setup("internlm2-1.8b", cuda)
    finals = []
    for dev in ("cpu", cuda):
        opt = adamw(1e-3, AdamWConfig(eps=1e-4))
        step = build_microbatched_train_step(
            lambda p, b: api.loss_fn(p, b), opt, 2)
        state = init_state(tree.tree_map(lambda t: t.clone().to(dev),
                                         p_cpu), opt)
        with full_float32_matmul():
            for i in range(3):
                batch = _batch(cfg, 4, 16, 20 + i)
                state, _ = step(state, {k: v.to(dev) for k, v in
                                        batch.items()})
        finals.append([t.cpu() for t in tree.leaves(state.params)])
    assert max(float((a - b).abs().max())
               for a, b in zip(*finals)) <= 1e-5


def test_bfloat16_decode_matches_its_prefill_on_the_card(cuda):
    """Reduced internlm2 at bfloat16: each decode step's logits against a
    fresh prefill over the tokens so far, within 16 bfloat16 ulps of the
    largest logit (chip_smoke.py's bound at full width)."""
    cfg, api, _, p_dev = _setup("internlm2-1.8b", cuda, dtype="bfloat16")
    seq = _batch(cfg, 2, 24, 5)["tokens"].to(cuda)
    with torch.no_grad():
        logits, cache = api.prefill(p_dev, {"tokens": seq})
        cache = _grown(api, cache, 2, 32, cuda)
        for t in range(4):
            seq = torch.cat([seq, torch.argmax(logits, -1)[:, None].to(
                torch.int32)], 1)
            logits, cache = api.decode_step(p_dev, {"token": seq[:, -1:]},
                                            cache, seq.shape[1] - 1)
            fresh, _ = api.prefill(p_dev, {"tokens": seq})
            scale = max(float(fresh.float().abs().max()), 1.0)
            assert float((logits.float() - fresh.float()).abs().max()) <= \
                16 * 2.0 ** -8 * scale
