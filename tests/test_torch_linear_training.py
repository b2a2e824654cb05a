"""Port vs reference: the paper's experiment — preprocessing, the
LIBLINEAR losses and objective, the analytic Hessian-vector product,
TRON, and both trainers (b-bit codes and VW sketches).

Inputs are made with numpy from a seed and fed to both packages; the
port runs on the CPU, so its kernels take their plain versions.  Codes
must equal the reference's byte for byte; losses, the objective, its
gradient and Hv agree at 1e-5; the trainers on the reference's own
fixture (tests/test_linear_training.py: 600 documents, k=64, b=8) take
the same number of TRON iterations, reach the same objective within
1e-4 relative, the same test accuracy, and tables allclose at 1e-3."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.vw import vw_hash_sparse as j_vw_hash_sparse
from repro.data import (SynthRcv1Config as JSynthConfig,
                        generate_arrays as j_generate_arrays,
                        preprocess_rows as j_preprocess_rows)
from repro.data.packing import pad_rows
from repro.models import linear as jlinear
from repro.train import losses as jlosses
from repro.train.linear_trainer import (
    make_liblinear_hvp as j_make_hvp,
    train_bbit_liblinear as j_train_bbit,
    train_vw_liblinear as j_train_vw,
)

from repro_torch.core.vw import vw_hash_sparse
from repro_torch.data.hashed_dataset import preprocess_rows
from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
from repro_torch.kernels import ops
from repro_torch.models import linear as tlinear
from repro_torch.optim.tron import ravel_params, tron_minimize
from repro_torch.train import losses as tlosses
from repro_torch.train.linear_trainer import (make_liblinear_hvp,
                                              train_bbit_liblinear,
                                              train_vw_liblinear)

N_TR = 400
K, B, M_VW = 64, 8, 16          # 64 x 8 bits = 512 bits = 16 float32 bins
CORPUS = dict(seed=11, topic_tokens=150, background_frac=0.35,
              max_pairs_per_doc=4000, max_triples_per_doc=2000)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def corpus():
    rows, labels = generate_arrays(600, SynthRcv1Config(**CORPUS))
    j_rows, j_labels = j_generate_arrays(600, JSynthConfig(**CORPUS))
    assert np.array_equal(labels, j_labels)
    assert all(np.array_equal(a, b) for a, b in zip(rows, j_rows))
    return rows, labels


@pytest.fixture(scope="module")
def hashed(corpus):
    rows, labels = corpus
    codes = preprocess_rows(rows, k=K, b=B, seed=1, chunk=256,
                            device="cpu")
    return codes, labels


@pytest.fixture(scope="module")
def sketches(corpus):
    rows, _ = corpus
    idx, nnz = pad_rows(rows)
    mask = np.arange(idx.shape[1])[None, :] < nnz[:, None]
    return vw_hash_sparse(torch.from_numpy(idx), torch.from_numpy(mask),
                          None, M_VW, seed=2).numpy()


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["minwise", "oph"])
@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_preprocess_rows_equals_reference(corpus, scheme, b):
    rows = corpus[0][:96]
    got = preprocess_rows(rows, k=32, b=b, scheme=scheme, seed=3, chunk=40,
                          device="cpu")
    want = j_preprocess_rows(rows, k=32, b=b, scheme=scheme, seed=3,
                             chunk=40)
    assert got.dtype == np.uint16 and got.shape == (96, 32)
    assert np.array_equal(got, want)


def test_preprocess_rows_fixture_equals_reference(corpus, hashed):
    want = j_preprocess_rows(corpus[0], k=K, b=B, seed=1, chunk=256)
    assert np.array_equal(hashed[0], want)


@pytest.mark.parametrize("kw", [dict(b=6), dict(b=16),
                                dict(scheme="oph_zero"),
                                dict(family="mod_prime")])
def test_preprocess_rows_beyond_the_packed_encode_equals_reference(corpus,
                                                                   kw):
    """The cases the packed encode (B1/B2) cannot give, through the
    raw-minima encode (B3/B4) or, for ``mod_prime``, the exact numpy
    path: the reference's codes byte for byte."""
    args = dict(b=8, scheme="minwise")
    args.update(kw)
    rows = corpus[0][:24]
    got = preprocess_rows(rows, k=32, seed=3, chunk=10, device="cpu", **args)
    want = j_preprocess_rows(rows, k=32, seed=3, chunk=10, **args)
    assert got.dtype == np.uint16 and got.shape == (24, 32)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
def test_losses_and_second_derivatives_match_reference():
    m = np.linspace(-30, 30, 241).astype(np.float32)
    for name in ("logistic", "hinge", "squared_hinge"):
        np.testing.assert_allclose(
            tlosses.LOSSES[name](torch.from_numpy(m)).numpy(),
            np.asarray(jlosses.LOSSES[name](jnp.asarray(m))), **TOL)
    for name in ("logistic", "squared_hinge"):
        np.testing.assert_allclose(
            tlosses.LOSS_D2[name](torch.from_numpy(m)).numpy(),
            np.asarray(jlosses.LOSS_D2[name](jnp.asarray(m))), **TOL)
    logits = np.random.default_rng(0).normal(size=(7, 1)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0, 0])
    np.testing.assert_allclose(
        tlosses.binary_margins(torch.from_numpy(logits),
                               torch.from_numpy(labels)).numpy(),
        np.asarray(jlosses.binary_margins(jnp.asarray(logits),
                                          jnp.asarray(labels))), **TOL)


def _params_pair(seed, k=K, b=B):
    rng = np.random.default_rng(seed)
    p = {"table": (0.05 * rng.normal(size=(k, 1 << b, 1))).astype(np.float32),
         "bias": np.array([0.3], np.float32)}
    return ({n: jnp.asarray(v) for n, v in p.items()},
            tlinear.params_from_jax(p, device="cpu"))


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
def test_objective_value_and_gradient_match_reference(hashed, loss):
    codes, labels = hashed
    jp, tp = _params_pair(1)
    jcfg, tcfg = (jlinear.BBitLinearConfig(k=K, b=B),
                  tlinear.BBitLinearConfig(k=K, b=B))
    jobj = jlosses.liblinear_objective(
        lambda p, c: jlinear.bbit_logits(p, c, jcfg), loss, 0.7)
    tobj = tlosses.liblinear_objective(
        lambda p, c: tlinear.bbit_logits(p, c, tcfg), loss, 0.7)
    jc, jy = jnp.asarray(codes.astype(np.int32)), jnp.asarray(labels)
    jval, jgrad = jax.value_and_grad(lambda p: jobj(p, jc, jy))(jp)
    tp = {n: v.requires_grad_(True) for n, v in tp.items()}
    tval = tobj(tp, torch.from_numpy(codes.astype(np.int32)),
                torch.from_numpy(labels))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for name in ("table", "bias"):
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jgrad[name]), **TOL)


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
def test_hvp_matches_reference(hashed, loss):
    codes, labels = hashed
    jp, tp = _params_pair(2)
    jv, tv = _params_pair(3)
    jcfg, tcfg = (jlinear.BBitLinearConfig(k=K, b=B),
                  tlinear.BBitLinearConfig(k=K, b=B))
    jhv = j_make_hvp(lambda p, c: jlinear.bbit_logits(p, c, jcfg), loss,
                     0.7, jnp.asarray(codes.astype(np.int32)),
                     jnp.asarray(labels))(jp, jv)
    ops.reset_counts()
    thv = make_liblinear_hvp(lambda p, c: tlinear.bbit_logits(p, c, tcfg),
                             loss, 0.7,
                             torch.from_numpy(codes.astype(np.int32)),
                             torch.from_numpy(labels))(tp, tv)
    assert ops.counts()["bbit_linear_bwd_dw_plain"] == 1
    for name in ("table", "bias"):
        np.testing.assert_allclose(thv[name].numpy(), np.asarray(jhv[name]),
                                   **TOL)


@pytest.mark.parametrize("before", [True, False])
def test_vw_logits_leaves_the_tf32_setting_as_it_was(before):
    """``vw_logits`` multiplies with TF32 off and then restores the
    process's ``allow_tf32``, whatever it was."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    try:
        flags.allow_tf32 = before
        seen = []

        def spy(a, b):
            seen.append(flags.allow_tf32)
            return a @ b

        cfg = tlinear.VWLinearConfig(m=8)
        params = tlinear.init_vw_linear(cfg, device="cpu")
        x = torch.ones((3, 8))
        real = torch.matmul
        torch.matmul = spy
        try:
            out = tlinear.vw_logits(params, x, cfg)
        finally:
            torch.matmul = real
        assert seen == [False]
        assert flags.allow_tf32 is before
        assert out.shape == (3, 1)
    finally:
        flags.allow_tf32 = saved


def test_ravel_order_is_ravel_pytrees():
    from jax.flatten_util import ravel_pytree
    jp, tp = _params_pair(4, k=4, b=2)
    flat, unravel = ravel_params(tp)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))
    back = unravel(flat)
    assert all(torch.equal(back[n], tp[n]) for n in tp)


def test_tron_matches_scipy_on_logistic():
    """tests/test_linear_training.py::test_tron_matches_scipy_on_logistic
    for the port: TRON (double-backward Hv) vs scipy L-BFGS on the same
    LIBLINEAR objective."""
    from scipy.optimize import minimize as scipy_minimize
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 12)).astype(np.float64)
    w_true = rng.normal(size=12)
    y01 = (X @ w_true + 0.3 * rng.normal(size=200) > 0).astype(np.float64)
    y = 2 * y01 - 1
    C = 0.7

    def f_np(w):
        m = y * (X @ w)
        return 0.5 * w @ w + C * np.sum(np.log1p(np.exp(-m)))

    res_sp = scipy_minimize(f_np, np.zeros(12), method="L-BFGS-B",
                            options=dict(maxiter=500, ftol=1e-12))
    Xt = torch.from_numpy(X.astype(np.float32))
    yt = torch.from_numpy(y.astype(np.float32))

    def f_t(w):
        m = yt * (Xt @ w)
        return 0.5 * w @ w + C * torch.sum(
            torch.logaddexp(torch.zeros_like(m), -m))

    res = tron_minimize(f_t, torch.zeros(12), max_iter=100, grad_tol=1e-4)
    assert abs(res.fun - res_sp.fun) / abs(res_sp.fun) < 1e-3
    np.testing.assert_allclose(res.params.numpy(), res_sp.x, atol=1e-1)


# ---------------------------------------------------------------------------
def _agree(port, ref, weight):
    assert port.n_iter == ref.n_iter, (port.n_iter, ref.n_iter)
    assert abs(port.objective - ref.objective) <= 1e-4 * abs(ref.objective)
    assert port.test_acc == ref.test_acc
    assert port.train_acc == ref.train_acc
    np.testing.assert_allclose(port.params[weight].cpu().numpy(),
                               np.asarray(ref.params[weight]), atol=1e-3)
    np.testing.assert_allclose(port.params["bias"].cpu().numpy(),
                               np.asarray(ref.params["bias"]), atol=1e-3)


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
def test_train_bbit_liblinear_matches_reference(hashed, loss):
    codes, labels = hashed
    split = (codes[:N_TR], labels[:N_TR], codes[N_TR:], labels[N_TR:])
    ref = j_train_bbit(*split, jlinear.BBitLinearConfig(k=K, b=B),
                       loss=loss, C=1.0, max_iter=30)
    port = train_bbit_liblinear(*split, tlinear.BBitLinearConfig(k=K, b=B),
                                loss=loss, C=1.0, max_iter=30, device="cpu")
    _agree(port, ref, "table")
    # the paper's thresholds (tests/test_linear_training.py), on the port
    assert port.test_acc > (0.9 if loss == "logistic" else 0.85)


@pytest.mark.parametrize("k,b", [(30, 12), (32, 16)])
def test_train_bbit_liblinear_matches_reference_at_wide_b(corpus, k, b):
    """The abstract's 30 hashes at b=12 (V=4096, the reference kernels'
    limit) and b=16 (V=65536, where the reference runs its gather and
    the port's B7/B8 still launch on the card), on codes of the
    raw-minima encode: the same TRON iterations, objective, accuracies
    and tables allclose at 1e-3; on the CPU through the plain versions."""
    rows, labels = corpus
    codes = preprocess_rows(rows, k=k, b=b, seed=1, chunk=256, device="cpu")
    assert np.array_equal(codes, j_preprocess_rows(rows, k=k, b=b, seed=1,
                                                   chunk=256))
    split = (codes[:N_TR], labels[:N_TR], codes[N_TR:], labels[N_TR:])
    ref = j_train_bbit(*split, jlinear.BBitLinearConfig(k=k, b=b),
                       loss="logistic", C=1.0, max_iter=30)
    ops.reset_counts()
    port = train_bbit_liblinear(*split, tlinear.BBitLinearConfig(k=k, b=b),
                                loss="logistic", C=1.0, max_iter=30,
                                device="cpu")
    _agree(port, ref, "table")
    counts = ops.counts()
    assert counts["bbit_linear_fwd_plain"] > 0
    assert counts["bbit_linear_bwd_dw_plain"] > 0


def test_train_vw_liblinear_matches_reference(corpus, sketches):
    rows, labels = corpus
    idx, nnz = pad_rows(rows)
    mask = np.arange(idx.shape[1])[None, :] < nnz[:, None]
    j_sk = np.asarray(j_vw_hash_sparse(jnp.asarray(idx), jnp.asarray(mask),
                                       None, M_VW, seed=2))
    assert np.array_equal(sketches, j_sk)
    split = (sketches[:N_TR], labels[:N_TR], sketches[N_TR:], labels[N_TR:])
    ref = j_train_vw(*split, jlinear.VWLinearConfig(m=M_VW), loss="logistic",
                     C=1.0, max_iter=30)
    port = train_vw_liblinear(*split, tlinear.VWLinearConfig(m=M_VW),
                              loss="logistic", C=1.0, max_iter=30,
                              device="cpu")
    _agree(port, ref, "w")


def test_bbit_beats_vw_at_equal_storage(hashed, sketches):
    """Figs 5-6 (tests/test_linear_training.py:72-105), on the port
    alone: 64 hashes x 8 bits = 16 float32 VW bins, b-bit wins by more
    than 0.05."""
    codes, labels = hashed
    bb = train_bbit_liblinear(codes[:N_TR], labels[:N_TR], codes[N_TR:],
                              labels[N_TR:],
                              tlinear.BBitLinearConfig(k=K, b=B),
                              max_iter=30, device="cpu")
    vw = train_vw_liblinear(sketches[:N_TR], labels[:N_TR],
                            sketches[N_TR:], labels[N_TR:],
                            tlinear.VWLinearConfig(m=M_VW), max_iter=30,
                            device="cpu")
    assert bb.test_acc > vw.test_acc + 0.05, (bb.test_acc, vw.test_acc)


def test_params_from_jax_carries_trained_weights(hashed, sketches):
    """A table and a VW weight trained by the reference predict the same
    classes in both packages after ``params_from_jax``."""
    codes, labels = hashed
    ref = j_train_bbit(codes[:N_TR], labels[:N_TR], codes[N_TR:],
                       labels[N_TR:], jlinear.BBitLinearConfig(k=K, b=B),
                       max_iter=10)
    jcfg, tcfg = (jlinear.BBitLinearConfig(k=K, b=B),
                  tlinear.BBitLinearConfig(k=K, b=B))
    params = tlinear.params_from_jax(
        {n: np.asarray(v) for n, v in ref.params.items()}, device="cpu")
    tc, jc = (torch.from_numpy(codes.astype(np.int32)),
              jnp.asarray(codes.astype(np.int32)))
    got = tlinear.predict_classes(params, tc, tcfg).numpy()
    want = np.asarray(jlinear.predict_classes(ref.params, jc, jcfg))
    assert np.array_equal(got, want)
    np.testing.assert_allclose(
        tlinear.bbit_scores(params, tc, tcfg).numpy(),
        np.asarray(jlinear.bbit_scores(ref.params, jc, jcfg)), **TOL)

    rng = np.random.default_rng(5)
    vw_np = {"w": rng.normal(size=(M_VW, 1)).astype(np.float32),
             "bias": np.array([0.1], np.float32)}
    vparams = tlinear.params_from_jax(vw_np, device="cpu")
    assert set(vparams) == {"w", "bias"}
    got = tlinear.vw_predict(vparams, torch.from_numpy(sketches),
                             tlinear.VWLinearConfig(m=M_VW)).numpy()
    want = np.asarray(jlinear.vw_predict(
        {n: jnp.asarray(v) for n, v in vw_np.items()},
        jnp.asarray(sketches), jlinear.VWLinearConfig(m=M_VW)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("loss,n_classes", [("logistic", 2),
                                            ("squared_hinge", 2),
                                            ("softmax", 3)])
def test_mean_loss_fn_matches_reference(hashed, loss, n_classes):
    """Value and gradient of the minibatch loss (with L2), binary and
    multiclass."""
    codes, labels = hashed
    rng = np.random.default_rng(6)
    jcfg, tcfg = (jlinear.BBitLinearConfig(k=K, b=B, n_classes=n_classes),
                  tlinear.BBitLinearConfig(k=K, b=B, n_classes=n_classes))
    p = {"table": (0.05 * rng.normal(size=(K, 1 << B, tcfg.n_out))
                   ).astype(np.float32),
         "bias": (0.1 * rng.normal(size=tcfg.n_out)).astype(np.float32)}
    if n_classes > 2:
        labels = rng.integers(0, n_classes, size=len(labels)).astype(np.int32)
    jval, jgrad = jax.value_and_grad(jlosses.mean_loss_fn(
        lambda q, c: jlinear.bbit_logits(q, c, jcfg), loss, l2=1e-3))(
        {n: jnp.asarray(v) for n, v in p.items()},
        jnp.asarray(codes.astype(np.int32)), jnp.asarray(labels))
    tp = {n: v.requires_grad_(True)
          for n, v in tlinear.params_from_jax(p, device="cpu").items()}
    tval = tlosses.mean_loss_fn(
        lambda q, c: tlinear.bbit_logits(q, c, tcfg), loss, l2=1e-3)(
        tp, torch.from_numpy(codes.astype(np.int32)),
        torch.from_numpy(labels))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for name in ("table", "bias"):
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jgrad[name]), **TOL)


def test_trainers_refuse_to_fall_back_to_the_cpu(hashed):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    codes, labels = hashed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_bbit_liblinear(codes[:8], labels[:8], codes[8:16],
                             labels[8:16], tlinear.BBitLinearConfig(k=K, b=B))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_rows([np.arange(5)], k=32, b=8)
