"""The LM zoo's serving and training entry points in the port against the
reference (ROADMAP A6a), on the CPU: ``greedy_generate`` (the same
tokens for every family), a decode write at the cache's last slot,
``build_microbatched_train_step`` (tests/test_train_integration.py:66's
quadratic problem, and reduced internlm2 under SGD and AdamW), and
``examples/lm_hashed_embeddings_torch.py``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _lm_parity import (Pair, batch_np, f32, grow, j_batch, pair, t_batch,
                        to_numpy)
from repro.optim.optimizers import AdamWConfig as JAdamWConfig
from repro.optim.optimizers import adamw as j_adamw
from repro.optim.optimizers import sgd as j_sgd
from repro.serving.engine import greedy_generate as j_generate
from repro.train import steps as j_steps

from repro_torch import tree
from repro_torch.optim.optimizers import AdamWConfig, adamw, sgd
from repro_torch.serving import greedy_generate
from repro_torch.serving.engine import grow_cache
from repro_torch.train import steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _extras(p: Pair, bnp: dict):
    return {k: v for k, v in bnp.items() if k not in ("tokens", "targets")}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-3b-a800m",
                                  "qwen2-vl-2b", "zamba2-7b", "xlstm-350m",
                                  "seamless-m4t-large-v2"])
def test_greedy_generate_tokens_match_reference(arch):
    p = pair(arch)
    bnp = batch_np(p.tcfg, 2, 12, 7)
    extras = _extras(p, bnp)
    got = greedy_generate(p.tapi, p.tparams, bnp["tokens"], 6,
                          extras=extras, device="cpu")
    want = j_generate(p.japi, p.jparams, bnp["tokens"], 6,
                      extras={k: jnp.asarray(v) for k, v in extras.items()})
    assert got.dtype == np.int32 and got.shape == (2, 18)
    assert np.array_equal(got[:, :12], bnp["tokens"])
    assert np.array_equal(got, want), (got[:, 12:], want[:, 12:])


def test_greedy_generate_edges():
    p = pair("internlm2-1.8b")
    prompt = batch_np(p.tcfg, 3, 5, 1)["tokens"]
    same = greedy_generate(p.tapi, p.tparams, prompt, 0, device="cpu")
    assert np.array_equal(same, prompt) and same is not prompt
    one = greedy_generate(p.tapi, p.tparams, prompt, 1, device="cpu")
    with torch.no_grad():
        logits, _ = p.tapi.prefill(p.tparams,
                                   {"tokens": torch.from_numpy(prompt)})
    assert np.array_equal(one[:, 5], np.argmax(logits.numpy(), -1))
    # a roomier cache than needed gives the same tokens
    a = greedy_generate(p.tapi, p.tparams, prompt, 4, device="cpu")
    b = greedy_generate(p.tapi, p.tparams, prompt, 4, max_len=32,
                        device="cpu")
    assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_decode_at_the_last_cache_slot_matches_reference(arch):
    """A prompt of max_len - 1 tokens: the decode step writes the cache's
    last slot (max_len - 1), in both packages."""
    p = pair(arch)
    max_len = 10
    bnp = batch_np(p.tcfg, 2, max_len - 1, 2)
    jb = {k: v for k, v in j_batch(bnp, p.jcfg).items() if k != "targets"}
    tb = {k: v for k, v in t_batch(bnp, p.tcfg).items() if k != "targets"}
    jlog, jcache = p.japi.prefill(p.jparams, jb)
    jc = jax.tree.map(grow, p.japi.init_cache(2, max_len), jcache)
    tok = bnp["tokens"][:, -1:]
    jd, jc2 = p.japi.decode_step(p.jparams, {"token": jnp.asarray(tok)},
                                 jc, jnp.asarray(max_len - 1, jnp.int32))
    with torch.no_grad():
        tlog, tcache = p.tapi.prefill(p.tparams, tb)
        tc = grow_cache(p.tapi.init_cache(2, max_len, device="cpu"),
                        tcache)
        td, tc2 = p.tapi.decode_step(p.tparams, {"token": torch.from_numpy(
            tok)}, tc, max_len - 1)
    np.testing.assert_allclose(f32(td), f32(jd), rtol=0, atol=1e-4)
    for a, b in zip(tree.leaves(tc2), tree.leaves(jc2)):
        np.testing.assert_allclose(f32(a), f32(b), rtol=0, atol=1e-4)
    kv = tc2["self"] if "self" in tc2 else tc2.get("attn", tc2)
    assert float(kv["k"][:, :, max_len - 1].abs().sum()) > 0


def _quadratic_problem():
    """tests/test_train_integration.py's problem, in both packages."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(16, 8)).astype(np.float32)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    target = a @ w_true + np.float32(0.3)
    ja, jt = jnp.asarray(a), jnp.asarray(target)
    ta, tt = torch.from_numpy(a), torch.from_numpy(target)

    def j_loss(params, idx):
        pred = ja[idx] @ params["w"] + params["b"]
        return jnp.mean((pred - jt[idx]) ** 2)

    def t_loss(params, idx):
        pred = ta[idx] @ params["w"] + params["b"]
        return torch.mean((pred - tt[idx]) ** 2)

    return (j_loss, {"w": jnp.zeros(8), "b": jnp.zeros(())},
            t_loss, {"w": torch.zeros(8), "b": torch.zeros(())})


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_microbatched_step_matches_reference_on_quadratic(opt, n_micro):
    j_loss, jp, t_loss, tp = _quadratic_problem()
    jopt, topt = ((j_sgd(0.1), sgd(0.1)) if opt == "sgd"
                  else (j_adamw(0.05), adamw(0.05)))
    jstep = j_steps.build_microbatched_train_step(j_loss, jopt, n_micro)
    tstep = steps.build_microbatched_train_step(t_loss, topt, n_micro)
    full = steps.build_train_step(t_loss, topt)
    js = j_steps.init_state(jp, jopt)
    ts = steps.init_state(tp, topt)
    fs = steps.init_state({k: v.clone() for k, v in tp.items()}, topt)
    idx = np.arange(16)
    for _ in range(3):
        js, jl = jstep(js, jnp.asarray(idx))
        ts, tl = tstep(ts, torch.from_numpy(idx))
        fs, fl = full(fs, torch.from_numpy(idx))
        assert abs(float(tl) - float(jl)) < 1e-6
        assert abs(float(tl) - float(fl)) < 1e-6
    for name in ("w", "b"):
        np.testing.assert_allclose(ts.params[name].numpy(),
                                   np.asarray(js.params[name]), atol=1e-6)
        # a mean loss: the mean of the microbatch gradients is the full
        # batch's (tests/test_train_integration.py's check)
        np.testing.assert_allclose(ts.params[name].numpy(),
                                   fs.params[name].numpy(), atol=1e-6)
    assert int(ts.step) == 3


@pytest.mark.parametrize("opt", ["sgd", "adamw", "adamw_eps1e-4"])
def test_microbatched_step_matches_reference_on_internlm2(opt):
    """Three steps at n_micro=2 on reduced internlm2, batches of 4
    sequences of 16: float32 gradient sums in order, the mean, then the
    update.  The losses agree within 1e-5 relative (3e-7 seen).  SGD
    (lr 0.1) is linear in the gradient: every param within 1e-5 (4e-7
    seen).  eps=1e-4 keeps AdamW's step Lipschitz near zero (|Δstep| <=
    lr·|Δg|/eps): every param within 1e-5 (2.3e-6 seen).  At eps=1e-8,
    m/(sqrt(v)+eps) turns a gradient element at float32 noise level
    (3e-9 seen, in leaves whose largest is O(1)), or a first moment that
    cancels across steps, into a full lr-sized step of the rounding's
    sign (1.3e-4 apart seen).  So there only the elements whose
    reference gradient keeps its sign over the three steps and stays
    above 1e-6 of its leaf's largest are held, within 1e-5 (2.7e-6
    seen): their moments do not cancel, and the step moves by about
    lr·|Δg|/|g|.  They are 23 % of the params; a step that trains on
    half the batch puts 52,380 of them more than 1e-5 apart (6e-3)."""
    p = Pair("internlm2-1.8b")
    lr, eps = {"sgd": (0.1, None), "adamw": (1e-3, 1e-8),
               "adamw_eps1e-4": (1e-3, 1e-4)}[opt]
    if eps is None:
        jopt, topt = j_sgd(lr), sgd(lr)
    else:
        jopt = j_adamw(lr, JAdamWConfig(eps=eps))
        topt = adamw(lr, AdamWConfig(eps=eps))
    jstep = j_steps.build_microbatched_train_step(
        lambda q, b: p.japi.loss_fn(q, b), jopt, 2)
    tstep = steps.build_microbatched_train_step(
        lambda q, b: p.tapi.loss_fn(q, b), topt, 2)
    jgrad = jax.jit(jax.grad(lambda q, b: p.japi.loss_fn(q, b)))
    js = j_steps.init_state(p.jparams, jopt)   # donated to the jitted step
    ts = steps.init_state(p.tparams, topt)
    held = None        # per leaf: the elements held, and their sign
    for i in range(3):
        bnp = batch_np(p.tcfg, 4, 16, 20 + i)
        if eps == 1e-8:
            g = [np.asarray(x, np.float32) for x in tree.leaves(
                to_numpy(jgrad(js.params, j_batch(bnp, p.jcfg))))]
            step = [(np.abs(x) > 1e-6 * np.abs(x).max(), np.sign(x))
                    for x in g]
            held = step if held is None else [
                (m & m1 & (s == s1), s)
                for (m, s), (m1, s1) in zip(held, step)]
        js, jl = jstep(js, j_batch(bnp, p.jcfg))
        ts, tl = tstep(ts, t_batch(bnp, p.tcfg))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = [a.numpy() for a in tree.leaves(ts.params)]
    want = [np.asarray(b) for b in tree.leaves(to_numpy(js.params))]
    if held is not None:
        got = [a[m] for a, (m, _) in zip(got, held)]
        want = [b[m] for b, (m, _) in zip(want, held)]
        n_held = sum(a.size for a in got)
        n_all = sum(t.numel() for t in tree.leaves(ts.params))
        assert n_held >= 0.2 * n_all, (n_held, n_all)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert isinstance(ts.params["layers"], dict)


def test_example_runs_on_the_cpu(tmp_path):
    # two threads: the test runs beside other test processes
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    name = "lm_hashed_embeddings_torch.py"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), "--device",
         "cpu", "--steps", "10"], capture_output=True, text=True, env=env,
        timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "4.0× compression" in proc.stdout
    with open(os.path.join(ROOT, "examples", name)) as f:
        source = f.read()
    assert "from repro." not in source and "import jax" not in source
