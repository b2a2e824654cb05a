"""Port vs reference: the packed-input linear forward (kernel B5) and
the model layer above it.

On the CPU the port's wrapper runs its plain torch version; it must be
allclose (rtol = atol = 1e-5, the reference's own tolerance in
tests/test_packed_linear.py) to the reference's Pallas kernel in
interpret mode and to its jnp oracle, with and without the oph_zero
empty mask, on weights moved across by ``params_from_jax``.  The sum
order differs between the two, so equality is not expected.  The CUDA
kernel itself is tested in test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.bbit import pack_codes
from repro.kernels import ref as jref
from repro.kernels.bbit_linear import bbit_linear_packed_fwd_pallas
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
    """b = 6 straddles bytes and 2^16 > BBIT_KERNEL_MAX_V: the plain
    torch version runs, on the plain counter, with the oracle's result."""
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
