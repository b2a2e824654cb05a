"""Port vs reference: the b-bit linear layer — forward from packed codes
(kernel B5) and from widened codes (B7), dW from widened (B8) and packed
codes (B6) — and the model layer above it.

On the CPU the port's wrappers run their plain torch versions; they must
be allclose to the reference's Pallas kernels in interpret mode and to
its jnp oracles, at the reference's own tolerances: atol 1e-4 on the
widened path (tests/test_kernels.py), rtol = atol = 1e-5 on the packed
path (tests/test_packed_linear.py), with and without the oph_zero empty
mask.  The sum order differs between the two, so equality is not
expected.  The CUDA kernels themselves are tested in
test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.bbit import pack_codes
from repro.kernels import ref as jref
from repro.kernels import ops as jops
from repro.kernels.bbit_linear import (bbit_linear_bwd_dw_pallas,
                                       bbit_linear_fwd_pallas,
                                       bbit_linear_packed_bwd_dw_pallas,
                                       bbit_linear_packed_fwd_pallas)
from repro.models import linear as jlinear

from repro_torch.kernels import bbit_linear, ops
from repro_torch.models import linear as tlinear

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(b, k, n=17, c=3, seed=None, empty_frac=0.0):
    rng = np.random.default_rng(b * 1031 + k if seed is None else seed)
    v = 1 << b
    codes = rng.integers(0, v, size=(n, k)).astype(np.uint16)
    packed = pack_codes(codes, b)
    weights = rng.normal(size=(k, v, c)).astype(np.float32)
    empty = None
    if empty_frac:
        mask = rng.random((n, k)) < empty_frac
        mask[0] = True        # all-empty row
        mask[1] = False
        empty = np.packbits(mask, axis=1)
    return packed, weights, empty


def _port(packed, weights, empty, k, b):
    params = tlinear.params_from_jax(
        {"table": weights, "bias": np.zeros(weights.shape[2], np.float32)},
        device="cpu")
    return bbit_linear.bbit_linear_packed_fwd(
        torch.from_numpy(packed), params["table"], k=k, bits=b,
        empty=None if empty is None else torch.from_numpy(empty)).numpy()


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [8, 37, 64])
@pytest.mark.parametrize("empty_frac", [0.0, 0.4])
def test_packed_fwd_plain_matches_pallas_and_oracle(b, k, empty_frac):
    packed, weights, empty = _case(b, k, empty_frac=empty_frac)
    jempty = None if empty is None else jnp.asarray(empty)
    kern = bbit_linear_packed_fwd_pallas(jnp.asarray(packed),
                                         jnp.asarray(weights), k=k, bits=b,
                                         empty=jempty, interpret=True)
    oracle = jref.bbit_linear_packed_fwd(jnp.asarray(packed),
                                         jnp.asarray(weights), k, b,
                                         empty=jempty)
    got = _port(packed, weights, empty, k, b)
    assert got.dtype == np.float32 and got.shape == (packed.shape[0], 3)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("b", [6, 16])
def test_unfused_arm_outside_eligibility(b):
    """b = 6 and b = 16 straddle bytes, outside the packed kernels'
    layout: the plain torch version runs, on the plain counter, with the
    oracle's result."""
    k = 8
    packed, weights, empty = _case(b, k, n=5, c=2, empty_frac=0.3)
    ops.reset_counts()
    got = ops.bbit_linear_packed(torch.from_numpy(packed),
                                 torch.from_numpy(weights), k, b,
                                 empty=torch.from_numpy(empty))
    assert ops.counts()["bbit_linear_packed_fwd_plain"] == 1
    assert ops.counts()["bbit_linear_packed_fwd"] == 0
    want = jref.bbit_linear_packed_fwd(jnp.asarray(packed),
                                       jnp.asarray(weights), k, b,
                                       empty=jnp.asarray(empty))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_classes", [2, 4])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_scores_packed_match_reference(n_classes, normalize, masked):
    k, b = 32, 4
    cfg_j = jlinear.BBitLinearConfig(k=k, b=b, n_classes=n_classes,
                                     normalize=normalize)
    cfg_t = tlinear.BBitLinearConfig(k=k, b=b, n_classes=n_classes,
                                     normalize=normalize)
    jparams = jlinear.init_bbit_linear(cfg_j, jax.random.key(n_classes))
    jparams = {"table": jparams["table"],
               "bias": jnp.linspace(-0.5, 0.5, cfg_j.n_out)}
    packed, _, empty = _case(b, k, n=9, empty_frac=0.5 if masked else 0.0)
    jempty = None if empty is None else jnp.asarray(empty)
    want = jlinear.bbit_scores_packed(jparams, jnp.asarray(packed), cfg_j,
                                      empty_packed=jempty)
    params = tlinear.params_from_jax(
        {name: np.asarray(v) for name, v in jparams.items()}, device="cpu")
    got = tlinear.bbit_scores_packed(
        params, torch.from_numpy(packed), cfg_t,
        empty_packed=None if empty is None else torch.from_numpy(empty))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_bbit_linear_is_seeded_and_shaped():
    cfg = tlinear.BBitLinearConfig(k=16, b=4, n_classes=3)
    p1 = tlinear.init_bbit_linear(cfg, torch.Generator().manual_seed(3),
                                  device="cpu")
    p2 = tlinear.init_bbit_linear(cfg, torch.Generator().manual_seed(3),
                                  device="cpu")
    assert tuple(p1["table"].shape) == (16, 16, 3)
    assert tuple(p1["bias"].shape) == (3,)
    assert torch.equal(p1["table"], p2["table"])
    assert float(p1["table"].std()) > 0
    zero = tlinear.init_bbit_linear(cfg, device="cpu")
    assert not zero["table"].any()


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tlinear.BBitLinearConfig(k=8, b=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlinear.init_bbit_linear(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlinear.params_from_jax({"table": np.zeros((8, 4, 1)),
                                 "bias": np.zeros(1)})


# ---------------------------------------------------------------------------
# Widened codes: B7 forward and B8 dW, and the autograd Function over them

@pytest.mark.parametrize("n,k,b,c", [
    (16, 8, 2, 1), (64, 30, 4, 3), (100, 200, 8, 2), (32, 10, 12, 5),
    (1, 1, 1, 1),
])
def test_widened_fwd_bwd_plain_match_pallas_and_oracle(n, k, b, c):
    rng = np.random.default_rng(n + k + b + c)
    v = 1 << b
    codes = rng.integers(0, v, size=(n, k)).astype(np.int32)
    w = rng.normal(size=(k, v, c)).astype(np.float32)
    dout = rng.normal(size=(n, c)).astype(np.float32)
    got = bbit_linear.bbit_linear_fwd(torch.from_numpy(codes),
                                      torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(bbit_linear_fwd_pallas(
        jnp.asarray(codes), jnp.asarray(w), interpret=True)), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jref.bbit_linear_fwd(
        jnp.asarray(codes), jnp.asarray(w))), atol=1e-4)
    got_dw = bbit_linear.bbit_linear_bwd_dw(
        torch.from_numpy(codes), torch.from_numpy(dout), v).numpy()
    assert got_dw.shape == (k, v, c)
    np.testing.assert_allclose(got_dw, np.asarray(bbit_linear_bwd_dw_pallas(
        jnp.asarray(codes), jnp.asarray(dout), v, interpret=True)),
        atol=1e-4)
    np.testing.assert_allclose(got_dw, np.asarray(jref.bbit_linear_bwd_dw(
        jnp.asarray(codes), jnp.asarray(dout), v)), atol=1e-4)


@pytest.mark.parametrize("b", [4, 12])
def test_bbit_linear_autograd_matches_jax_grad(b):
    """d/dW of Σ tanh(logits) through the port's ``ops.bbit_linear``
    (B7 forward, B8 backward) ≡ ``jax.grad`` through the reference's
    ``custom_vjp`` (interpret-mode kernels)."""
    rng = np.random.default_rng(6 + b)
    v = 1 << b
    codes = rng.integers(0, v, size=(24, 12)).astype(np.int32)
    w = rng.normal(size=(12, v, 3)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jnp.tanh(jops.bbit_linear(
        jnp.asarray(codes), x, True))))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    ops.reset_counts()
    torch.sum(torch.tanh(ops.bbit_linear(torch.from_numpy(codes),
                                         wt))).backward()
    counts = ops.counts()
    assert counts["bbit_linear_fwd_plain"] == 1
    assert counts["bbit_linear_bwd_dw_plain"] == 1
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), atol=1e-4)


def test_bbit_linear_beyond_max_v_takes_the_plain_path():
    """V = 2^13, beyond the reference kernels' V <= 4096 (the reference
    runs its gather there): on CPU tensors the port's plain versions
    run, on the plain counters, with the reference's results.  On the
    card B7/B8 take any V (tests/test_torch_kernels_cuda.py)."""
    rng = np.random.default_rng(10)
    codes = rng.integers(0, 1 << 13, size=(4, 6)).astype(np.int32)
    w = rng.normal(size=(6, 1 << 13, 1)).astype(np.float32)
    wt = torch.from_numpy(w).requires_grad_(True)
    ops.reset_counts()
    out = ops.bbit_linear(torch.from_numpy(codes), wt)
    out.sum().backward()
    assert ops.counts()["bbit_linear_fwd_plain"] == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jref.bbit_linear_fwd(jnp.asarray(codes), jnp.asarray(w))), atol=1e-4)
    want = jref.bbit_linear_bwd_dw(jnp.asarray(codes),
                                   jnp.ones((4, 1), jnp.float32), 1 << 13)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), atol=1e-4)


def test_masked_bbit_logits_matches_reference_on_the_plain_counters():
    """``bbit_logits`` with a bool empty mask (zero-coded OPH) ≡ the
    reference's masked gather, value and ``jax.grad``; both directions
    run through ``ops.bbit_linear_masked`` and count as plain calls."""
    rng = np.random.default_rng(12)
    k, b, n = 10, 4, 21
    codes = rng.integers(0, 1 << b, size=(n, k)).astype(np.int32)
    mask = rng.random((n, k)) < 0.3
    mask[0] = True
    w = rng.normal(size=(k, 1 << b, 1)).astype(np.float32)
    jcfg = jlinear.BBitLinearConfig(k=k, b=b)
    jparams = {"table": jnp.asarray(w), "bias": jnp.asarray([0.25],
                                                            jnp.float32)}

    def jloss(p):
        return jnp.sum(jnp.tanh(jlinear.bbit_logits(
            p, jnp.asarray(codes), jcfg, empty=jnp.asarray(mask))))

    want_grad = jax.grad(jloss)(jparams)
    want = jlinear.bbit_logits(jparams, jnp.asarray(codes), jcfg,
                               empty=jnp.asarray(mask))
    tp = {n_: torch.from_numpy(np.array(v)).requires_grad_(True)
          for n_, v in jparams.items()}
    ops.reset_counts()
    out = tlinear.bbit_logits(tp, torch.from_numpy(codes),
                              tlinear.BBitLinearConfig(k=k, b=b),
                              empty=torch.from_numpy(mask))
    torch.sum(torch.tanh(out)).backward()
    counts = ops.counts()
    assert counts["bbit_linear_fwd_plain"] == 1
    assert counts["bbit_linear_bwd_dw_plain"] == 1
    assert counts["bbit_linear_fwd"] == counts["bbit_linear_bwd_dw"] == 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    for name in ("table", "bias"):
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(want_grad[name]), **TOL)


# ---------------------------------------------------------------------------
# Packed codes: B6 dW and the autograd Function over B5/B6

@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [8, 37, 64])
@pytest.mark.parametrize("empty_frac", [0.0, 0.4])
def test_packed_bwd_dw_plain_matches_pallas_and_oracle(b, k, empty_frac):
    packed, _, empty = _case(b, k, empty_frac=empty_frac)
    v = 1 << b
    dout = np.random.default_rng(b + k).normal(
        size=(packed.shape[0], 3)).astype(np.float32)
    jempty = None if empty is None else jnp.asarray(empty)
    kern = bbit_linear_packed_bwd_dw_pallas(
        jnp.asarray(packed), jnp.asarray(dout), v, k=k, bits=b,
        empty=jempty, interpret=True)
    oracle = jref.bbit_linear_packed_bwd_dw(jnp.asarray(packed),
                                            jnp.asarray(dout), v, k, b,
                                            empty=jempty)
    got = bbit_linear.bbit_linear_packed_bwd_dw(
        torch.from_numpy(packed), torch.from_numpy(dout), v, k=k, bits=b,
        empty=None if empty is None else torch.from_numpy(empty)).numpy()
    assert got.dtype == np.float32 and got.shape == (k, v, 3)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_packed_autograd_matches_jax_grad(masked):
    """d/dW of Σ logits² through ``ops.bbit_linear_packed`` (B5 forward,
    B6 backward) ≡ ``jax.grad`` through the reference's packed
    ``custom_vjp``."""
    k, b = 16, 4
    packed, weights, empty = _case(b, k, empty_frac=0.4 if masked else 0.0)
    jempty = None if empty is None else jnp.asarray(empty)
    want = jax.grad(lambda w: jnp.sum(jops.bbit_linear_packed(
        jnp.asarray(packed), w, k, b, empty=jempty,
        interpret=True) ** 2))(jnp.asarray(weights))
    wt = torch.from_numpy(weights).requires_grad_(True)
    ops.reset_counts()
    out = ops.bbit_linear_packed(
        torch.from_numpy(packed), wt, k, b,
        empty=None if empty is None else torch.from_numpy(empty))
    torch.sum(out ** 2).backward()
    assert ops.counts()["bbit_linear_packed_bwd_dw_plain"] == 1
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_logits_packed_gradient_matches_widened_gradient(masked):
    """The gradient through ``bbit_logits_packed`` equals the one through
    the widened codes (``bbit_logits``, with the empty mask as a bool
    matrix), and the reference's."""
    k, b = 24, 8
    cfg_t = tlinear.BBitLinearConfig(k=k, b=b)
    cfg_j = jlinear.BBitLinearConfig(k=k, b=b)
    packed, weights, empty = _case(b, k, n=21, c=1,
                                   empty_frac=0.3 if masked else 0.0)
    labels = np.random.default_rng(1).integers(0, 2, size=21)
    jparams = {"table": jnp.asarray(weights),
               "bias": jnp.asarray([0.2], jnp.float32)}

    def jloss(p):
        z = jlinear.bbit_logits_packed(
            p, jnp.asarray(packed), cfg_j,
            empty_packed=None if empty is None else jnp.asarray(empty))
        return jnp.mean(jnp.logaddexp(0.0, -(2.0 * labels - 1) * z[:, 0]))

    want = jax.grad(jloss)(jparams)
    params = tlinear.params_from_jax(
        {n: np.asarray(v) for n, v in jparams.items()}, device="cpu")
    from repro_torch.core.bbit import unpack_codes_torch, unpack_mask_torch
    from repro_torch.train.losses import mean_loss_fn
    y = torch.from_numpy(labels)
    tp = torch.from_numpy(packed)
    te = None if empty is None else torch.from_numpy(empty)
    grads = []
    for widened in (False, True):
        p = {n: v.clone().requires_grad_(True) for n, v in params.items()}
        if widened:
            codes = unpack_codes_torch(tp, k, b)
            mask = None if te is None else unpack_mask_torch(te, k)
            fwd = (lambda q, c: tlinear.bbit_logits(q, c, cfg_t,
                                                    empty=mask))
            x = codes
        else:
            fwd = (lambda q, c: tlinear.bbit_logits_packed(
                q, c, cfg_t, empty_packed=te))
            x = tp
        mean_loss_fn(fwd, "logistic")(p, x, y).backward()
        grads.append({n: v.grad.numpy() for n, v in p.items()})
    for name in ("table", "bias"):
        np.testing.assert_allclose(grads[0][name], grads[1][name], **TOL)
        np.testing.assert_allclose(grads[0][name], np.asarray(want[name]),
                                   **TOL)
