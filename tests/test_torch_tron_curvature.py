"""TRON's Hessian products keep ℓ″(y·Xw) for each iterate.

``make_liblinear_hvp`` computes ℓ″ at the first product at a params
object and reuses it while the same tensors, unwritten, come back; TRON
hands every product at one iterate the same params object.  Held here
to the two-forward formula written out below (X·w and X·v on every
call), bit for bit: single products over both losses, float32 and
bfloat16 params (with a float32 or a bfloat16 v) and the VW model; the
forward and transposed products that k products at one params cost; a
fresh ℓ″ for other params or for tensors written in place; and whole
TRON fits against fits run with the formula, on the CPU and (one test,
marked ``cuda``) on the card through B7/B8:

    python -m pytest -q -m cuda tests/test_torch_tron_curvature.py

The file imports nothing of JAX, so it runs where only torch is
installed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import linear as tlinear
from repro_torch.train import linear_trainer
from repro_torch.train.losses import LOSS_D2
from repro_torch.train.linear_trainer import (make_liblinear_hvp,
                                              train_bbit_liblinear,
                                              train_vw_liblinear)

K, B, N, N_TR = 16, 4, 240, 200


def two_forward_hvp(forward, loss, C, codes, labels):
    """The oracle: Hv = v + C·Xᵀ(ℓ″(y·Xw)⊙Xv) with X·w computed again on
    every call, Xᵀ· through the graph of that forward at the params."""
    d2_fn = LOSS_D2[loss]
    y = 2.0 * labels.to(torch.float32) - 1.0

    def hvp(params, v):
        names = sorted(params)
        p = {name: params[name].detach().requires_grad_(True)
             for name in names}
        with torch.enable_grad():
            logits = forward(p, codes)
        with torch.no_grad():
            d2 = d2_fn(y * logits[:, 0])
            jv = forward(v, codes)[:, 0]
            hv_logits = (C * d2 * jv)[:, None]
        hv = torch.autograd.grad(logits, [p[name] for name in names],
                                 hv_logits)
        return {name: v[name].to(torch.float32) + h.to(torch.float32)
                for name, h in zip(names, hv)}

    return hvp


def _problem(seed, n=N, k=K, b=B):
    """Codes that copy their class's prototype in 40 % of the bins."""
    rng = np.random.default_rng(seed)
    proto = rng.integers(0, 1 << b, size=(2, k))
    y = rng.integers(0, 2, size=n).astype(np.int32)
    copy = rng.random((n, k)) < 0.4
    codes = np.where(copy, proto[y], rng.integers(0, 1 << b, size=(n, k)))
    return codes.astype(np.int32), y


def _random_params(seed, model, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    shape = (K, 1 << B, 1) if model == "bbit" else (K, 1)
    name = "table" if model == "bbit" else "w"
    return {name: (0.05 * torch.randn(shape, generator=gen)).to(dtype),
            "bias": (0.3 * torch.randn((1,), generator=gen)).to(dtype)}


def _model(model, dtype="float32"):
    """(forward, inputs, labels) of a small problem on the CPU."""
    codes, y = _problem(3)
    if model == "bbit":
        cfg = tlinear.BBitLinearConfig(k=K, b=B, param_dtype=dtype)
        forward = lambda p, c: tlinear.bbit_logits(p, c, cfg)   # noqa: E731
        x = torch.from_numpy(codes)
    else:
        cfg = tlinear.VWLinearConfig(m=K)
        forward = lambda p, s: tlinear.vw_logits(p, s, cfg)     # noqa: E731
        x = torch.from_numpy(codes.astype(np.float32) / (1 << B))
    return forward, x, torch.from_numpy(y)


_WORDS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _words(t):
    return t.view(_WORDS[t.dtype])


def _bitwise(a, b):
    """Two dicts of float tensors hold the same bits (-0.0 is not 0.0)."""
    return set(a) == set(b) and all(
        a[n].dtype == b[n].dtype and torch.equal(_words(a[n]), _words(b[n]))
        for n in a)


@pytest.mark.parametrize("model,loss,p_dtype,v_dtype", [
    ("bbit", "logistic", torch.float32, torch.float32),
    ("bbit", "squared_hinge", torch.float32, torch.float32),
    ("bbit", "logistic", torch.bfloat16, torch.float32),
    ("bbit", "squared_hinge", torch.bfloat16, torch.float32),
    ("bbit", "logistic", torch.bfloat16, torch.bfloat16),
    ("vw", "logistic", torch.float32, torch.float32),
    ("vw", "squared_hinge", torch.float32, torch.float32),
])
def test_hvp_bitwise_equals_the_two_forward_formula(model, loss, p_dtype,
                                                    v_dtype):
    """A bfloat16 start meets a float32 v after TRON's first CG step:
    its Xᵀ· must still be the bits of the backward in bfloat16."""
    dtype = "bfloat16" if p_dtype == torch.bfloat16 else "float32"
    forward, x, y = _model(model, dtype=dtype)
    params = _random_params(1, model, p_dtype)
    v = _random_params(2, model, v_dtype)
    want = two_forward_hvp(forward, loss, 0.7, x, y)(params, v)
    hvp = make_liblinear_hvp(forward, loss, 0.7, x, y)
    assert _bitwise(hvp(params, v), want)
    assert _bitwise(hvp(params, v), want)             # from the kept ℓ″


@pytest.mark.parametrize("k_products", [1, 3, 6])
def test_products_at_one_params_cost_one_forward_more(k_products):
    """k products at one params: k + 1 forward products (the formula
    takes 2k) and k transposed ones; one ℓ″ built, k − 1 reused."""
    forward, x, y = _model("bbit")
    params = _random_params(1, "bbit")
    vs = [_random_params(10 + i, "bbit") for i in range(k_products)]
    oracle = two_forward_hvp(forward, "logistic", 0.7, x, y)
    ops.reset_counts()
    want = [oracle(params, v) for v in vs]
    was = ops.counts()
    assert was["bbit_linear_fwd_plain"] == 2 * k_products
    hvp = make_liblinear_hvp(forward, "logistic", 0.7, x, y)
    ops.reset_counts()
    got = [hvp(params, v) for v in vs]
    counts = ops.counts()
    assert all(_bitwise(g, w) for g, w in zip(got, want))
    assert counts["bbit_linear_fwd_plain"] == k_products + 1
    assert counts["bbit_linear_bwd_dw_plain"] == k_products
    assert counts["trainer.curvature_builds"] == 1
    assert counts["trainer.curvature_hits"] == k_products - 1
    ops.reset_counts()


@pytest.mark.parametrize("change", ["other_tensors", "same_values_copied",
                                    "written_in_place", "table_only"])
def test_other_or_rewritten_params_get_a_fresh_curvature(change):
    """Params other than the last, or the last written in place, never
    read a stale ℓ″: the product equals a new hvp's and ℓ″ is built
    again.  A new dict of the same, unwritten tensors reuses it."""
    forward, x, y = _model("bbit")
    hvp = make_liblinear_hvp(forward, "logistic", 0.7, x, y)
    first = _random_params(1, "bbit")
    v = _random_params(2, "bbit")
    hvp(first, v)
    if change == "other_tensors":
        at = _random_params(3, "bbit")
    elif change == "same_values_copied":
        at = {n: t.clone() for n, t in first.items()}
    elif change == "written_in_place":
        at = first
        at["table"].mul_(-3.0)
        at["bias"].add_(1.0)
    else:
        at = first
        at["table"][0, 0, 0] += 2.0
    ops.reset_counts()
    got = hvp(at, v)
    assert ops.counts()["trainer.curvature_builds"] == 1
    assert ops.counts()["trainer.curvature_hits"] == 0
    assert _bitwise(got, make_liblinear_hvp(forward, "logistic", 0.7, x,
                                            y)(at, v))
    assert _bitwise(got, two_forward_hvp(forward, "logistic", 0.7, x,
                                         y)(at, v))
    ops.reset_counts()
    again = hvp(dict(at), v)
    assert _bitwise(again, got)
    assert ops.counts()["trainer.curvature_hits"] == 1
    assert ops.counts()["trainer.curvature_builds"] == 0
    ops.reset_counts()


class _Watched:
    """The oracle's products and the iterates that had one (a product at
    params unequal to the previous product's)."""

    def __init__(self):
        self.products = self.iterates = 0
        self.last = None

    def builder(self, *args):
        oracle = two_forward_hvp(*args)

        def hvp(params, v):
            now = {n: t.clone() for n, t in params.items()}
            if self.last is None or not _bitwise(now, self.last):
                self.iterates += 1
            self.last = now
            self.products += 1
            return oracle(params, v)

        return hvp


def _fit_both(monkeypatch, fit):
    """(fit with the kept ℓ″ and its counts, fit with the formula and its
    counts, the formula's products and iterates)."""
    ops.reset_counts()
    new = fit()
    new_counts = ops.counts()
    watched = _Watched()
    with monkeypatch.context() as m:
        m.setattr(linear_trainer, "make_liblinear_hvp", watched.builder)
        ops.reset_counts()
        old = fit()
        old_counts = ops.counts()
    ops.reset_counts()
    assert _bitwise(new.params, old.params)
    assert (new.n_iter, new.objective) == (old.n_iter, old.objective)
    assert (new.train_acc, new.test_acc) == (old.train_acc, old.test_acc)
    assert new_counts["tron.cg_steps"] == old_counts["tron.cg_steps"]
    assert new_counts["tron.host_reads"] == old_counts["tron.host_reads"]
    assert new_counts["trainer.curvature_builds"] == watched.iterates
    assert new_counts["trainer.curvature_hits"] == \
        watched.products - watched.iterates > 0
    return new_counts, old_counts, watched


@pytest.mark.parametrize("loss,dtype", [("logistic", "float32"),
                                        ("squared_hinge", "float32"),
                                        ("logistic", "bfloat16")])
def test_tron_fit_bitwise_equals_the_formulas_fit(monkeypatch, loss, dtype):
    """``train_bbit_liblinear`` with the kept ℓ″ against the same fit
    with the formula: the same params, objective, iterations and
    accuracies, and B7 called once less for each product that reused an
    iterate's ℓ″ (products less iterates that had one), B8 as often."""
    codes, y = _problem(3)
    cfg = tlinear.BBitLinearConfig(k=K, b=B, param_dtype=dtype)
    new, old, watched = _fit_both(monkeypatch, lambda: train_bbit_liblinear(
        codes[:N_TR], y[:N_TR], codes[N_TR:], y[N_TR:], cfg, loss=loss,
        max_iter=20, device="cpu"))
    assert old["bbit_linear_fwd_plain"] - new["bbit_linear_fwd_plain"] == \
        watched.products - watched.iterates
    assert new["bbit_linear_bwd_dw_plain"] == old["bbit_linear_bwd_dw_plain"]


def test_vw_tron_fit_bitwise_equals_the_formulas_fit(monkeypatch):
    codes, y = _problem(3)
    sk = codes.astype(np.float32) / (1 << B)
    _fit_both(monkeypatch, lambda: train_vw_liblinear(
        sk[:N_TR], y[:N_TR], sk[N_TR:], y[N_TR:],
        tlinear.VWLinearConfig(m=K), max_iter=20, device="cpu"))


@pytest.mark.cuda
def test_card_fit_bitwise_equals_the_formulas_fit(monkeypatch):
    """k=64, b=16 on the card: the fit through B7/B8 with the kept ℓ″ is
    the formula's fit bit for bit, with no plain call on either."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    k, b, n, n_tr = 64, 16, 20_000, 16_000
    codes, y = _problem(7, n=n, k=k, b=b)
    cfg = tlinear.BBitLinearConfig(k=k, b=b)
    new, old, watched = _fit_both(monkeypatch, lambda: train_bbit_liblinear(
        codes[:n_tr], y[:n_tr], codes[n_tr:], y[n_tr:], cfg,
        device="cuda"))
    for counts in (new, old):
        assert not any(v for name, v in counts.items()
                       if name.endswith("_plain")), counts
    assert old["bbit_linear_fwd"] - new["bbit_linear_fwd"] == \
        watched.products - watched.iterates
    assert new["bbit_linear_bwd_dw"] == old["bbit_linear_bwd_dw"]
