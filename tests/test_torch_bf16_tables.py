"""Port vs reference: bfloat16 b-bit tables (``BBitLinearConfig.param_dtype
= "bfloat16"``) through the linear layer, the trainers, checkpoints and
serving, on the CPU (the kernels' plain versions).

Inputs are made with numpy from a seed and fed to both packages.  The
reference's kernel arm is its TPU path (``ops.bbit_linear`` and
``ops.bbit_linear_packed``, the ``custom_vjp``s whose dW is summed in
float32 and cast to the table's dtype); off a TPU it takes it only with
``use_kernel="always"``, and then runs its Pallas kernels in interpret
mode, as tests/test_kernels.py does.  Its CPU arm (``use_kernel="auto"``)
differentiates an XLA gather instead, which scatter-adds dW in bfloat16
(ROADMAP C9), so the port, whose every arm sums in float32 as the
kernels do, is held to the kernel arm wherever dW matters.

  * logits (widened and packed codes, with and without the ``oph_zero``
    mask) at float32's 1e-4: widening bfloat16 is exact, so only the
    order of the float32 sum differs; dW within one bfloat16 ulp (the
    float32 sums, taken in another order, may round to neighbours);
  * fits from the reference's start: ``fit_streaming`` and
    ``train_bbit_sgd`` with AdamW keep a bfloat16 table and a float32
    Polyak mean, their params within ``BF16_FIT_TOL``; SGD widens the
    table to float32 after one step (ROADMAP C7) and is then held at
    tests/test_torch_streaming.py's SGD tolerance; TRON from a bfloat16
    start ends float32, its objective within ``FIT_OBJECTIVE_RTOL``;
  * the data-parallel fold at two slots against the reference's dp arm
    (behind tests/test_torch_dp_streaming.py's ``shard_map`` shim);
  * checkpoints and published snapshots across packages (``|V2`` words;
    the reference cannot restore its own, ROADMAP C8), resume bitwise;
  * an engine serving a bfloat16 table, bitwise equal to one serving the
    table widened, hot-swapped from either package's snapshot.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import repro.train.data_parallel as j_data_parallel
from repro.ckpt import checkpoint as jckpt
from repro.data import hashed_dataset as jhd
from repro.kernels import ops as jops
from repro.models import linear as jlinear
from repro.models.linear import BBitLinearConfig as JCfg
from repro.train import fit_streaming as j_fit_streaming
from repro.train import train_bbit_sgd as j_train_bbit_sgd
from repro.train.linear_trainer import train_bbit_liblinear as j_tron

from repro_torch import perf
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.core.bbit import pack_codes
from repro_torch.data import hashed_dataset as thd
from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
from repro_torch.kernels import bbit_linear as tbl
from repro_torch.kernels import ops
from repro_torch.models import linear as tlinear
from repro_torch.models.linear import BBitLinearConfig, params_from_jax
from repro_torch.serving import (HashedClassifierEngine, ReloadManager,
                                 load_serving_params)
from repro_torch.train import (fit_streaming, linear_trainer,
                               train_bbit_liblinear, train_bbit_sgd,
                               trees_bitwise_equal)

BF16 = "bfloat16"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16 params after an AdamW fit: one bfloat16 ulp relative (8
# significant bits: a neighbour lies within 2^-7 of the value), and 1e-4
# absolute for a bin whose douts cancel to a float32 sum the size of
# AdamW's eps, where the order of the sum picks the step (measured on
# this fixture: 3.1e-5 at a value of 1.4e-4; 1.2e-4 for a one-ulp flip
# at 0.017)
BF16_FIT_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
SGD_TOL = dict(rtol=1e-5, atol=1e-7)
FIT_OBJECTIVE_RTOL = 1e-3
CORPUS = dict(seed=11, topic_tokens=150, background_frac=0.35,
              max_pairs_per_doc=4000, max_triples_per_doc=2000)
K, B, N_TR = 64, 8, 400


def _f32(x) -> np.ndarray:
    """A tensor or jax array of any float dtype as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ordered(x: np.ndarray) -> np.ndarray:
    """bfloat16 words as integers ordered like the values (±0 alike)."""
    i = x.astype(ml_dtypes.bfloat16).view(np.int16).astype(np.int32)
    return np.where(i >= 0, i, -(i & 0x7FFF))


def _assert_bf16_ulps(got: torch.Tensor, want, ulps: int = 1) -> None:
    assert got.dtype == torch.bfloat16
    want = np.asarray(want)
    assert want.dtype == ml_dtypes.bfloat16
    dist = np.abs(_ordered(_f32(got)) - _ordered(want.astype(np.float32)))
    assert dist.max() <= ulps, (int(dist.max()), int((dist > ulps).sum()))


def _bf16_params(k, b, seed=0, n_classes=2):
    """The reference's bfloat16 draw, as numpy (ml_dtypes) arrays."""
    p = jlinear.init_bbit_linear(
        JCfg(k=k, b=b, n_classes=n_classes, param_dtype=BF16),
        jax.random.key(seed))
    return {n: np.asarray(v) for n, v in p.items()}


@pytest.fixture
def reference_start(monkeypatch):
    """The port's SGD fits start from the reference's draw of
    ``jax.random.key(seed)`` in the config's dtype."""
    def start(cfg, seed, device):
        jcfg = JCfg(k=cfg.k, b=cfg.b, n_classes=cfg.n_classes,
                    normalize=cfg.normalize, param_dtype=cfg.param_dtype)
        return params_from_jax(
            {n: np.asarray(v)
             for n, v in jlinear.init_bbit_linear(
                 jcfg, jax.random.key(seed)).items()}, device=device)
    monkeypatch.setattr(linear_trainer, "_initial_params", start)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_torch_streaming.py's fixture: 600 documents, a 400-row
    5-shard archive at k=64, b=8 written by each package, and the codes
    of all 600 rows."""
    rows, labels = generate_arrays(600, SynthRcv1Config(**CORPUS))
    d = tmp_path_factory.mktemp("bf16")
    ref, port = str(d / "ref"), str(d / "port")
    kw = dict(k=K, b=B, n_shards=5, seed=1, chunk=128)
    jhd.preprocess_and_save(ref, rows[:N_TR], labels[:N_TR], **kw)
    thd.preprocess_and_save(port, rows[:N_TR], labels[:N_TR], device="cpu",
                            **kw)
    codes = thd.preprocess_rows(rows, k=K, b=B, seed=1, chunk=256,
                                device="cpu")
    return rows, labels, ref, port, codes


# --------------------------------------------------------------- kernels --
def _inputs(seed, n, k, bits, c=1):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, size=(n, k)).astype(np.int32)
    table = rng.normal(size=(k, 1 << bits, c)).astype(ml_dtypes.bfloat16)
    empty = rng.random((n, k)) < 0.25
    dout = rng.normal(size=(n, c)).astype(np.float32)
    return codes, table, empty, dout


def _port_grad(fn, table_np, dout):
    """(logits, dW) of ``fn(table)`` on the CPU, dW of sum(logits·dout)."""
    table = params_from_jax({"table": table_np, "bias": table_np[0, 0]},
                            device="cpu")["table"].requires_grad_(True)
    out = fn(table)
    out.backward(torch.from_numpy(dout))
    return out.detach(), table.grad


def _ref_grad(fn, table_np, dout):
    table = jnp.asarray(table_np)
    out, vjp = jax.vjp(fn, table)
    return np.asarray(out), np.asarray(vjp(jnp.asarray(dout))[0])


@pytest.mark.parametrize("bits,c", [(1, 1), (4, 3), (8, 1)])
def test_widened_logits_and_dw_match_reference_kernels(bits, c):
    codes, table, _, dout = _inputs(bits, 48, 24, bits, c)
    got, gdw = _port_grad(
        lambda t: ops.bbit_linear(torch.from_numpy(codes), t), table, dout)
    want, wdw = _ref_grad(
        lambda t: jops.bbit_linear(jnp.asarray(codes), t, interpret=True),
        table, dout)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert wdw.dtype == ml_dtypes.bfloat16
    _assert_bf16_ulps(gdw, wdw)
    # the bfloat16 table's logits are the widened table's, bit for bit
    wide = ops.bbit_linear(torch.from_numpy(codes),
                           torch.from_numpy(table.astype(np.float32)))
    assert torch.equal(got, wide)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits", [2, 8])
def test_packed_logits_and_dw_match_reference_kernels(bits, masked):
    k = 40
    codes, table, empty, dout = _inputs(10 + bits, 56, k, bits)
    packed = pack_codes(codes.astype(np.uint16), bits)
    em = np.packbits(empty, axis=1) if masked else None
    got, gdw = _port_grad(
        lambda t: ops.bbit_linear_packed(
            torch.from_numpy(packed), t, k, bits,
            empty=None if em is None else torch.from_numpy(em)),
        table, dout)
    want, wdw = _ref_grad(
        lambda t: jops.bbit_linear_packed(
            jnp.asarray(packed), t, k, bits,
            empty=None if em is None else jnp.asarray(em), interpret=True),
        table, dout)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _assert_bf16_ulps(gdw, wdw)


@pytest.mark.parametrize("masked", [False, True])
def test_model_logits_match_reference_at_bf16(masked):
    """``bbit_logits`` / ``bbit_logits_packed`` of the models: float32
    logits over a bfloat16 table and bias, the reference's kernel arm
    (widened codes; the masked widened product is a plain gather in both
    packages) and packed arm."""
    codes, table, empty, _ = _inputs(3, 40, K, B)
    params_np = _bf16_params(K, B, seed=4)
    params_np["table"] = table
    params_np["bias"] = np.asarray([0.37], ml_dtypes.bfloat16)
    params = params_from_jax(params_np, device="cpu")
    assert params["table"].dtype == params["bias"].dtype == torch.bfloat16
    cfg = BBitLinearConfig(k=K, b=B, param_dtype=BF16)
    jcfg = JCfg(k=K, b=B, param_dtype=BF16, use_kernel="always")
    jparams = {n: jnp.asarray(v) for n, v in params_np.items()}
    em = empty if masked else None
    got = tlinear.bbit_logits(params, torch.from_numpy(codes), cfg,
                              empty=None if em is None
                              else torch.from_numpy(em))
    want = jlinear.bbit_logits(jparams, jnp.asarray(codes), jcfg,
                               empty=None if em is None else jnp.asarray(em))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    packed = pack_codes(codes.astype(np.uint16), B)
    pem = np.packbits(empty, axis=1) if masked else None
    got = tlinear.bbit_logits_packed(
        params, torch.from_numpy(packed), cfg,
        empty_packed=None if pem is None else torch.from_numpy(pem))
    want = jlinear.bbit_logits_packed(
        jparams, jnp.asarray(packed), jcfg,
        empty_packed=None if pem is None else jnp.asarray(pem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_dw_wrappers_give_the_table_dtype():
    """On the CPU the dW wrappers sum in float32 and round: bfloat16 dW
    is the float32 dW rounded by ``.to(torch.bfloat16)``, bit for bit,
    and any other dtype is refused."""
    codes, _, empty, dout = _inputs(5, 64, 16, 4)
    c, d = torch.from_numpy(codes), torch.from_numpy(dout)
    f32 = tbl.bbit_linear_bwd_dw(c, d, 16)
    bf = tbl.bbit_linear_bwd_dw(c, d, 16, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf.view(torch.int16),
                       f32.to(torch.bfloat16).view(torch.int16))
    packed = torch.from_numpy(pack_codes(codes.astype(np.uint16), 4))
    em = torch.from_numpy(np.packbits(empty, axis=1))
    f32 = tbl.bbit_linear_packed_bwd_dw(packed, d, 16, k=16, bits=4, empty=em)
    bf = tbl.bbit_linear_packed_bwd_dw(packed, d, 16, k=16, bits=4, empty=em,
                                       dtype=torch.bfloat16)
    assert torch.equal(bf.view(torch.int16),
                       f32.to(torch.bfloat16).view(torch.int16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tbl.bbit_linear_bwd_dw(c, d, 16, torch.float16)


def test_eligibility_and_counters_do_not_depend_on_the_dtype():
    """The cost model's shapes carry no dtype (nor do the reference's):
    a bfloat16 table takes the arm a float32 one takes.  On the CPU that
    is the plain arm, counted on the kernel's ``_plain`` counter and not
    on its ``_bf16`` launches."""
    shape = {"k": K, "b": B, "v": 1 << B, "rows": 8}
    for op in ("logits", "logits_packed", "logits_bwd", "logits_packed_bwd"):
        assert "dtype" not in shape
        assert perf.choose(op, shape, device="cpu") == "plain"
    codes, table, _, dout = _inputs(6, 8, K, B)
    ops.reset_counts()
    _port_grad(lambda t: ops.bbit_linear(torch.from_numpy(codes), t), table,
               dout)
    counts = ops.counts()
    assert counts["bbit_linear_fwd_plain"] == counts[
        "bbit_linear_bwd_dw_plain"] == 1
    assert {n for n in counts if n.endswith("_bf16")} == {
        "bbit_linear_packed_fwd_bf16", "bbit_linear_packed_bwd_dw_bf16",
        "bbit_linear_fwd_bf16", "bbit_linear_bwd_dw_bf16"}
    assert all(v == 0 for n, v in counts.items() if n.endswith("_bf16"))


# ------------------------------------------------------- carrying weights --
def test_params_from_jax_keeps_bfloat16_words():
    p = _bf16_params(16, 4, seed=2)
    got = params_from_jax(p, device="cpu")
    for name in ("table", "bias"):
        assert got[name].dtype == torch.bfloat16
        assert np.array_equal(got[name].view(torch.int16).numpy(),
                              p[name].view(np.int16))
    # the checkpoints' 2-byte void words are read the same way
    words = {n: v.view(np.int16).view("V2") for n, v in p.items()}
    again = params_from_jax(words, device="cpu")
    assert trees_bitwise_equal(got, again)
    # float32 (and float64) arrays still become float32
    assert params_from_jax({n: v.astype(np.float64) for n, v in p.items()},
                           device="cpu")["table"].dtype == torch.float32


def test_init_makes_table_and_bias_in_the_config_dtype():
    cfg = BBitLinearConfig(k=8, b=2, param_dtype=BF16)
    for gen in (None, torch.Generator().manual_seed(0)):
        p = tlinear.init_bbit_linear(cfg, gen, device="cpu")
        assert p["table"].dtype == p["bias"].dtype == torch.bfloat16
    want = jlinear.init_bbit_linear(JCfg(k=8, b=2, param_dtype=BF16))
    assert want["table"].dtype == want["bias"].dtype == jnp.bfloat16


# ------------------------------------------------------------------ fits --
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_fit_streaming_bf16_matches_reference(optimizer, corpus,
                                              reference_start):
    _, _, ref, port, _ = corpus
    kw = dict(epochs=2, batch_size=64, lr=5e-3, seed=0, optimizer=optimizer)
    want = j_fit_streaming(ref, JCfg(k=K, b=B, param_dtype=BF16,
                                     use_kernel="always"), **kw)
    got = fit_streaming(port, BBitLinearConfig(k=K, b=B, param_dtype=BF16),
                        device="cpu", **kw)
    assert (got.n_steps, got.examples_seen, got.shards_processed) == (
        want.n_steps, want.examples_seen, want.shards_processed)
    assert got.progressive_acc == want.progressive_acc
    # AdamW keeps the table bfloat16; SGD widens it (ROADMAP C7); the
    # Polyak mean is float32 either way
    table = torch.bfloat16 if optimizer == "adamw" else torch.float32
    assert want.params["table"].dtype == (
        jnp.bfloat16 if optimizer == "adamw" else jnp.float32)
    for name in ("table", "bias"):
        assert got.params[name].dtype == table
        assert got.eval_params[name].dtype == torch.float32
        assert want.eval_params[name].dtype == jnp.float32
    tol = BF16_FIT_TOL if optimizer == "adamw" else SGD_TOL
    for which in ("params", "avg_params"):
        for name in ("table", "bias"):
            np.testing.assert_allclose(
                _f32(getattr(got, which)[name]),
                _f32(getattr(want, which)[name]), **tol,
                err_msg=f"{which}[{name}]")


def test_fit_streaming_bf16_resume_is_bitwise(corpus, tmp_path):
    _, _, _, port, _ = corpus
    cfg = BBitLinearConfig(k=K, b=B, param_dtype=BF16)
    kw = dict(epochs=2, batch_size=64, lr=5e-3, seed=0, device="cpu")
    straight = fit_streaming(port, cfg, **kw)
    ck = str(tmp_path / "ck")
    part = fit_streaming(port, cfg, ckpt_dir=ck, stop_after_shards=3, **kw)
    assert not part.completed
    leaves = np.load(os.path.join(ck, f"step_{3:08d}", "ckpt.npz"))
    assert any(leaves[n].dtype == np.dtype("V2") for n in leaves.files)
    resumed = fit_streaming(port, cfg, ckpt_dir=ck, **kw)
    assert resumed.completed
    assert resumed.params["table"].dtype == torch.bfloat16
    assert trees_bitwise_equal(straight.params, resumed.params)
    assert trees_bitwise_equal(straight.avg_params, resumed.avg_params)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_train_bbit_sgd_bf16_matches_reference(optimizer, corpus,
                                               reference_start):
    _, labels, _, _, codes = corpus
    kw = dict(epochs=2, batch_size=64, lr=5e-3, optimizer=optimizer)
    want = j_train_bbit_sgd(codes[:N_TR], labels[:N_TR], codes[N_TR:],
                            labels[N_TR:], JCfg(k=K, b=B, param_dtype=BF16,
                                                use_kernel="always"), **kw)
    got = train_bbit_sgd(codes[:N_TR], labels[:N_TR], codes[N_TR:],
                         labels[N_TR:],
                         BBitLinearConfig(k=K, b=B, param_dtype=BF16),
                         device="cpu", **kw)
    table = torch.bfloat16 if optimizer == "adamw" else torch.float32
    assert got.params["table"].dtype == got.params["bias"].dtype == table
    assert _f32(want.params["table"]).dtype == np.float32
    assert (want.params["table"].dtype == jnp.bfloat16) == (
        optimizer == "adamw")
    tol = BF16_FIT_TOL if optimizer == "adamw" else SGD_TOL
    for name in ("table", "bias"):
        np.testing.assert_allclose(_f32(got.params[name]),
                                   _f32(want.params[name]), **tol)
    assert got.test_acc == want.test_acc
    assert got.n_iter == want.n_iter


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_widens_a_bf16_leaf_as_the_reference_does(momentum, nesterov):
    """ROADMAP C7: ``p - lr_t * g`` with a float32 ``lr_t`` gives a float32
    leaf; the momentum buffer stays bfloat16 for one step (the factor
    rounded to bfloat16, as jnp rounds a Python scalar), then widens with
    the gradient.  Both packages, three steps, bitwise."""
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers as topt
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(6, 16, 1)).astype(ml_dtypes.bfloat16)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(3)]
    jo = jopt.sgd(0.1, momentum=momentum, nesterov=nesterov)
    to = topt.sgd(0.1, momentum=momentum, nesterov=nesterov)
    jp = {"table": jnp.asarray(p0)}
    tp = params_from_jax({"table": p0, "bias": p0[0, 0]},
                         device="cpu")
    tp.pop("bias")
    js, ts = jo.init(jp), to.init(tp)
    for i, g in enumerate(grads):
        # the gradient comes in the leaf's dtype (dW is cast to it)
        jg = {"table": jnp.asarray(g).astype(jp["table"].dtype)}
        tg = {"table": torch.from_numpy(g).to(tp["table"].dtype)}
        jp, js = jo.update(jg, js, jp, jnp.asarray(i, jnp.int32))
        tp, ts = to.update(tg, ts, tp, torch.tensor(i, dtype=torch.int32))
        assert tp["table"].dtype == torch.float32
        assert jp["table"].dtype == jnp.float32
        np.testing.assert_array_equal(_f32(tp["table"]),
                                      np.asarray(jp["table"]))
        if momentum:
            want = jnp.bfloat16 if i == 0 else jnp.float32
            assert js["table"].dtype == want
            assert ts["table"].dtype == (torch.bfloat16 if i == 0
                                         else torch.float32)
            np.testing.assert_array_equal(_f32(ts["table"]),
                                          _f32(js["table"]))


def test_adamw_rounds_a_bf16_leaf_as_the_reference_does():
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers as topt
    rng = np.random.default_rng(8)
    p0 = rng.normal(size=(6, 16, 1)).astype(ml_dtypes.bfloat16)
    for wd in (0.0, 0.01):
        jo = jopt.adamw(1e-2, jopt.AdamWConfig(weight_decay=wd))
        to = topt.adamw(1e-2, topt.AdamWConfig(weight_decay=wd))
        jp = {"table": jnp.asarray(p0)}
        tp = {"table": params_from_jax({"table": p0, "bias": p0[0, 0]},
                                       device="cpu")["table"]}
        js, ts = jo.init(jp), to.init(tp)
        for i in range(4):
            g = rng.normal(size=p0.shape).astype(ml_dtypes.bfloat16)
            jp, js = jo.update({"table": jnp.asarray(g)}, js, jp,
                               jnp.asarray(i, jnp.int32))
            tp, ts = to.update(
                params_from_jax({"table": g, "bias": g[0, 0]},
                                device="cpu"), ts, tp,
                torch.tensor(i, dtype=torch.int32))
            assert tp["table"].dtype == torch.bfloat16
            assert np.array_equal(tp["table"].view(torch.int16).numpy(),
                                  np.asarray(jp["table"]).view(np.int16))


def test_tron_from_a_bf16_start_ends_float32(corpus):
    _, labels, _, _, codes = corpus
    want = j_tron(codes[:N_TR], labels[:N_TR], codes[N_TR:], labels[N_TR:],
                  JCfg(k=K, b=B, param_dtype=BF16))
    got = train_bbit_liblinear(codes[:N_TR], labels[:N_TR], codes[N_TR:],
                               labels[N_TR:],
                               BBitLinearConfig(k=K, b=B, param_dtype=BF16),
                               device="cpu")
    for name in ("table", "bias"):
        assert want.params[name].dtype == jnp.float32
        assert got.params[name].dtype == torch.float32
    assert abs(got.objective - want.objective) <= (
        FIT_OBJECTIVE_RTOL * abs(want.objective))
    assert got.test_acc == want.test_acc


def test_tron_ravel_keeps_the_leaves_dtype():
    """TRON flattens as ``ravel_pytree`` does: one bfloat16 vector from
    bfloat16 leaves, and an unravel that keeps the dtype it is given."""
    from repro_torch.optim.tron import ravel_params
    p = {"table": torch.ones((2, 2, 1), dtype=torch.bfloat16),
         "bias": torch.zeros((1,), dtype=torch.bfloat16)}
    flat, unravel = ravel_params(p)
    assert flat.dtype == torch.bfloat16 and flat.shape == (5,)
    assert unravel(flat.float())["table"].dtype == torch.float32
    mixed, unravel = ravel_params({"table": p["table"],
                                   "bias": torch.zeros(1)})
    assert mixed.dtype == torch.float32
    assert unravel(mixed)["table"].dtype == torch.bfloat16


# ------------------------------------------------------------------- dp --
@pytest.fixture
def reference_dp(monkeypatch, reference_start):
    _sm = jax.shard_map

    def shim(f, **kw):
        kw.pop("check_rep", None)
        return _sm(f, check_vma=False, **kw)
    monkeypatch.setattr(j_data_parallel, "shard_map", shim)


def test_dp_fold_bf16_matches_reference(corpus, reference_dp):
    """The fold of two logical slots onto one device: each slot's dW in
    bfloat16, their sum and the scale (cast to the gradient's dtype) as
    the reference's dp arm takes them."""
    _, _, ref, port, _ = corpus
    kw = dict(epochs=2, batch_size=32, lr=5e-3, seed=0, data_parallel=2,
              elastic=True)
    want = j_fit_streaming(ref, JCfg(k=K, b=B, param_dtype=BF16,
                                     use_kernel="always"), **kw)
    got = fit_streaming(port, BBitLinearConfig(k=K, b=B, param_dtype=BF16),
                        device="cpu", **kw)
    assert (got.n_steps, got.examples_seen) == (want.n_steps,
                                                want.examples_seen)
    assert got.progressive_acc == want.progressive_acc
    assert got.params["table"].dtype == torch.bfloat16
    assert got.avg_params["table"].dtype == torch.float32
    for which in ("params", "avg_params"):
        for name in ("table", "bias"):
            np.testing.assert_allclose(
                _f32(getattr(got, which)[name]),
                _f32(getattr(want, which)[name]), **BF16_FIT_TOL,
                err_msg=f"{which}[{name}]")


# ----------------------------------------------------------- checkpoints --
def _bf16_tree():
    p = _bf16_params(16, 4, seed=3)
    return p, params_from_jax(p, device="cpu")


def test_checkpoints_of_bf16_params_across_packages(tmp_path):
    """Both packages store a bfloat16 leaf as the same ``|V2`` words; the
    port restores either package's into a bfloat16 template bit for bit.
    The reference cannot cast ``|V2`` back to bfloat16 (ROADMAP C8): its
    restore fails on its own checkpoint and on the port's alike."""
    p_np, p_t = _bf16_tree()
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(jdir, 1, {n: jnp.asarray(v) for n, v in p_np.items()})
    tckpt.save(tdir, 1, p_t)
    files = []
    for d in (jdir, tdir):
        with np.load(os.path.join(d, f"step_{1:08d}", "ckpt.npz")) as z:
            files.append({n: z[n] for n in z.files})
    assert sorted(files[0]) == sorted(files[1])
    for name, arr in files[0].items():
        assert arr.dtype == files[1][name].dtype == np.dtype("V2")
        assert arr.tobytes() == files[1][name].tobytes()
    template = {n: torch.zeros_like(t) for n, t in p_t.items()}
    for d in (jdir, tdir):
        got, step = tckpt.restore(d, template)
        assert step == 1 and trees_bitwise_equal(got, p_t)
        with pytest.raises(ValueError):
            jckpt.restore(d, p_np)


def test_published_bf16_snapshots_serve_from_either_package(tmp_path):
    """``load_serving_params`` and ``swap_weights`` take a bfloat16
    snapshot whichever package published it; the engine keeps it
    bfloat16 and scores it bitwise as the table widened."""
    k, b = 16, 4
    p_np, p_t = _bf16_tree()
    cfg = BBitLinearConfig(k=k, b=b, param_dtype=BF16)
    docs = [np.unique(np.random.default_rng(i).integers(0, 1 << 20, 40))
            for i in range(12)]
    wide = {n: t.float() for n, t in p_t.items()}
    with HashedClassifierEngine(wide, cfg, device="cpu",
                                nnz_buckets=(128,)) as eng:
        assert eng.params["table"].dtype == torch.float32
        want = eng.score_docs(docs)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.publish_params(jdir, 2, {n: jnp.asarray(v) for n, v in p_np.items()})
    tckpt.publish_params(tdir, 2, p_t)
    zero = {n: torch.zeros_like(t) for n, t in p_t.items()}
    for d in (jdir, tdir):
        got, step = load_serving_params(d, zero)
        assert step == 2 and trees_bitwise_equal(got, p_t)
        with HashedClassifierEngine(zero, cfg, device="cpu",
                                    nnz_buckets=(128,)) as eng:
            assert eng.params["table"].dtype == torch.bfloat16
            info = ReloadManager(eng).reload_from_checkpoint(d)
            assert info["step"] == 2
            assert eng.params["table"].dtype == torch.bfloat16
            assert trees_bitwise_equal(eng.params, p_t)
            assert np.array_equal(eng.score_docs(docs), want)
            # a swap of numpy words keeps them bfloat16 too
            eng.swap_weights({n: v.view(np.int16).view("V2")
                              for n, v in p_np.items()}, "words")
            assert trees_bitwise_equal(eng.params, p_t)
    # a float32 snapshot (a Polyak mean) into a bfloat16 engine rounds to
    # nearest even, as the reference's template cast does
    mean = {n: np.asarray(v, np.float32) + np.float32(1e-3)
            for n, v in p_np.items()}
    fdir = str(tmp_path / "f32")
    tckpt.publish_params(fdir, 3, {n: torch.from_numpy(v)
                                   for n, v in mean.items()})
    tmpl = {n: np.zeros(v.shape, ml_dtypes.bfloat16) for n, v in p_np.items()}
    jgot, _ = jckpt.restore_published(fdir, tmpl)
    tgot, _ = load_serving_params(fdir, {n: torch.zeros_like(t)
                                         for n, t in p_t.items()})
    for name in ("table", "bias"):
        assert tgot[name].dtype == torch.bfloat16
        assert np.array_equal(tgot[name].view(torch.int16).numpy(),
                              np.asarray(jgot[name]).view(np.int16))


def test_engine_serving_a_bf16_table_matches_the_reference_engine():
    from repro.serving import HashedClassifierEngine as JEngine
    k, b = 32, 8
    p_np = _bf16_params(k, b, seed=5)
    docs = [np.unique(np.random.default_rng(50 + i).integers(0, 1 << 24, 60))
            for i in range(20)]
    for scheme in ("minwise", "oph", "oph_zero"):
        cfg = BBitLinearConfig(k=k, b=b, param_dtype=BF16)
        with HashedClassifierEngine(params_from_jax(p_np, device="cpu"),
                                    cfg, seed=1, scheme=scheme,
                                    device="cpu", nnz_buckets=(128,)) as eng:
            assert eng.params["table"].dtype == torch.bfloat16
            got = eng.score_docs(docs)
        ref = JEngine({n: jnp.asarray(v) for n, v in p_np.items()},
                      JCfg(k=k, b=b, param_dtype=BF16), seed=1,
                      scheme=scheme, nnz_buckets=(128,), row_buckets=(1, 32))
        want = ref.score_docs(docs)
        ref.close()
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=1e-5, atol=1e-5)
