"""Port vs reference: the paper's streaming path — optimizers, schedules
and Polyak averaging; the packed shard archive; in-memory SGD and
streaming SGD; and, within the port, resume and prefetch determinism and
the streaming trainer's refusals.

Inputs are made with numpy from a seed and fed to both packages; the
port runs on the CPU, so its kernels take their plain versions.  The
fixture is the reference's own (tests/test_streaming.py): 600 documents,
seed 11, a 400-row / 5-shard archive at k=64, b=8.

  * optimizers (sgd, momentum, Nesterov, adamw with weight decay 0 and
    0.01, adamw on a schedule) over five steps and the Polyak mean: the
    same float32 operations in the same order, so bitwise; the schedules
    allclose at 1e-6 / 1e-7 (cos and sqrt may round in another ulp);
  * archives: every ``.npy`` byte-equal, ``meta.json`` equal but for its
    timings; each package reads the other's archive, v2 included;
  * ``train_bbit_sgd`` and ``fit_streaming`` from the reference's start
    (``params_from_jax``): params and average allclose at rtol 1e-5 /
    atol 1e-7 for sgd (largest difference measured: 3.7e-9) and rtol
    1e-4 / atol 1e-5 for adamw (2.8e-7 streaming, 9.9e-7 in memory); the
    same steps, rows and progressive accuracy.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import (SynthRcv1Config as JSynthConfig,
                        generate_arrays as j_generate_arrays)
from repro.data import hashed_dataset as jhd
from repro.models.linear import (BBitLinearConfig as JCfg,
                                 init_bbit_linear as j_init)
from repro.optim import averaging as javg
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import losses as jlosses
from repro.train import fit_streaming as j_fit_streaming
from repro.train import train_bbit_sgd as j_train_bbit_sgd

from repro_torch import tree
from repro_torch.data import hashed_dataset as thd
from repro_torch.data.prefetch import ThreadedPrefetcher
from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
from repro_torch.models import linear as tlinear
from repro_torch.models.linear import BBitLinearConfig, params_from_jax
from repro_torch.optim import averaging as tavg
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train import linear_trainer, losses as tlosses
from repro_torch.train.linear_trainer import train_bbit_sgd
from repro_torch.train.metrics import batched_accuracy, trees_bitwise_equal
from repro_torch.train.steps import (build_averaged_train_step,
                                     init_averaged_state)
from repro_torch.train.streaming import fit_streaming

CORPUS = dict(seed=11, topic_tokens=150, background_frac=0.35,
              max_pairs_per_doc=4000, max_triples_per_doc=2000)
K, B, N_TR = 64, 8, 400
LCFG = BBitLinearConfig(k=K, b=B)
FIT_KW = dict(epochs=2, batch_size=64, lr=5e-3, seed=0)
TOL = {"sgd": dict(rtol=1e-5, atol=1e-7), "adamw": dict(rtol=1e-4, atol=1e-5)}
# the reference's minibatch fixture writes its archive with seed 1, chunk 128
ARCHIVE_KW = dict(seed=1, chunk=128)


def _np_params(params) -> dict:
    return {name: np.asarray(v) for name, v in params.items()}


def _close(port, ref, **tol):
    for name in ("bias", "table"):
        np.testing.assert_allclose(port[name].numpy(), np.asarray(ref[name]),
                                   **tol, err_msg=name)


@pytest.fixture
def reference_start(monkeypatch):
    """The port's SGD fits start from the reference's draw of
    ``jax.random.key(seed)`` (torch cannot reproduce it)."""
    def start(cfg, seed, device):
        jcfg = JCfg(k=cfg.k, b=cfg.b, n_classes=cfg.n_classes,
                    normalize=cfg.normalize)
        return params_from_jax(_np_params(j_init(jcfg, jax.random.key(seed))),
                               device=device)
    monkeypatch.setattr(linear_trainer, "_initial_params", start)


@pytest.fixture(scope="module")
def corpus():
    rows, labels = generate_arrays(600, SynthRcv1Config(**CORPUS))
    j_rows, j_labels = j_generate_arrays(600, JSynthConfig(**CORPUS))
    assert np.array_equal(labels, j_labels)
    assert all(np.array_equal(a, b) for a, b in zip(rows, j_rows))
    return rows, labels


@pytest.fixture(scope="module")
def archives(corpus, tmp_path_factory):
    """The reference's fixture archive, written by each package, and
    both packages' full 600-row code matrix."""
    rows, labels = corpus
    d = tmp_path_factory.mktemp("arch")
    ref, port = str(d / "ref"), str(d / "port")
    jhd.preprocess_and_save(ref, rows[:N_TR], labels[:N_TR], k=K, b=B,
                            n_shards=5, **ARCHIVE_KW)
    thd.preprocess_and_save(port, rows[:N_TR], labels[:N_TR], k=K, b=B,
                            n_shards=5, device="cpu", **ARCHIVE_KW)
    codes = thd.preprocess_rows(rows, k=K, b=B, seed=1, chunk=256,
                                device="cpu")
    assert np.array_equal(codes, jhd.preprocess_rows(rows, k=K, b=B, seed=1,
                                                     chunk=256))
    return ref, port, codes, labels


# ------------------------------------------------------------ optimizers --
OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "nesterov": lambda m: m.sgd(0.1, momentum=0.9, nesterov=True),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw_wd": lambda m: m.adamw(1e-2, m.AdamWConfig(weight_decay=0.01)),
}


def _trees(seed):
    rng = np.random.default_rng(seed)
    p = {"table": rng.normal(size=(6, 16, 1)).astype(np.float32),
         "bias": rng.normal(size=(1,)).astype(np.float32)}
    grads = [{n: rng.normal(size=v.shape).astype(np.float32)
              for n, v in p.items()} for _ in range(5)]
    return p, grads


def _run_both(j_opt, t_opt, seed):
    p0, grads = _trees(seed)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    js = j_opt.init(jp)
    tp = {n: torch.tensor(v) for n, v in p0.items()}
    ts = t_opt.init(tp)
    for i, g in enumerate(grads):
        jp, js = j_opt.update({n: jnp.asarray(v) for n, v in g.items()},
                              js, jp, jnp.asarray(i, jnp.int32))
        tp, ts = t_opt.update({n: torch.tensor(v) for n, v in g.items()},
                              ts, tp, torch.tensor(i, dtype=torch.int32))
        yield jp, tp, js, ts


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    make = OPTIMIZERS[name]
    for jp, tp, js, ts in _run_both(make(jopt), make(topt), seed=3):
        assert trees_bitwise_equal(tp, _np_params(jp)), name
        assert trees_bitwise_equal(ts, jax.tree.map(np.asarray, js)), name


def test_optimizer_on_a_schedule_matches_reference():
    j_o = jopt.adamw(jsched.warmup_cosine(1e-2, 2, 5))
    t_o = topt.adamw(tsched.warmup_cosine(1e-2, 2, 5))
    for jp, tp, _, _ in _run_both(j_o, t_o, seed=4):
        _close(tp, jp, rtol=1e-6, atol=1e-7)


def test_make_optimizer_names_and_refusals():
    for name in ("sgd", "momentum", "adamw"):
        for (jp, tp, _, _) in _run_both(jopt.make_optimizer(name, 0.05),
                                        topt.make_optimizer(name, 0.05), 5):
            assert trees_bitwise_equal(tp, _np_params(jp)), name
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lion", 0.1)
    for md in ("bfloat16", "int8"):
        for (jp, tp, js, ts) in _run_both(
                jopt.make_optimizer("adamw", 0.05, moment_dtype=md),
                topt.make_optimizer("adamw", 0.05, moment_dtype=md), 5):
            _close(tp, jp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("warmup_cosine", (1e-2, 100, 1000)),
    ("warmup_cosine", (1e-2, 0, 50)), ("inverse_sqrt", (1e-2, 100)),
    ("inverse_sqrt", (1e-2, 0))])
def test_schedules_match_reference(name, args):
    j_f, t_f = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    steps = np.arange(0, 1200, 7)
    want = np.array([float(j_f(jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.array([float(t_f(torch.tensor(s, dtype=torch.int32)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_polyak_update_matches_reference():
    rng = np.random.default_rng(7)
    p0, _ = _trees(7)
    j_avg, j_cnt = javg.init_average(p0)
    t_avg, t_cnt = tavg.init_average({n: torch.tensor(v)
                                      for n, v in p0.items()})
    assert tavg.average_or_none(t_avg, t_cnt) is None
    for active in (0, 0, 1, 1, 1, 0, 1):
        p = {n: rng.normal(size=v.shape).astype(np.float32)
             for n, v in p0.items()}
        j_avg, j_cnt = javg.polyak_update(
            j_avg, j_cnt, {n: jnp.asarray(v) for n, v in p.items()},
            np.float32(active))
        t_avg, t_cnt = tavg.polyak_update(
            t_avg, t_cnt, {n: torch.tensor(v) for n, v in p.items()},
            np.float32(active))
        assert trees_bitwise_equal(t_avg, _np_params(j_avg))
    assert float(t_cnt) == float(j_cnt) == 4.0
    assert tavg.average_or_none(t_avg, t_cnt) is t_avg


def test_polyak_average_equals_mean_of_iterates():
    cfg = BBitLinearConfig(k=8, b=4)
    opt = topt.make_optimizer("sgd", 0.1)
    loss_fn = tlosses.mean_loss_fn(
        lambda p, c: tlinear.bbit_logits(p, c, cfg), "logistic")
    step = build_averaged_train_step(loss_fn, opt)
    astate = init_averaged_state(tlinear.init_bbit_linear(
        cfg, torch.Generator().manual_seed(0), device="cpu"), opt)
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 16, size=(32, 8)).astype(
        np.int32))
    y = (codes.sum(dim=1) % 2).to(torch.int32)
    iterates = []
    for t in range(6):
        astate, _ = step(astate, np.float32(t >= 2), codes, y)
        if t >= 2:
            iterates.append({n: v.clone() for n, v in
                             astate.state.params.items()})
    assert float(astate.avg_count) == 4.0 and int(astate.state.step) == 6
    for name in ("bias", "table"):
        want = torch.stack([it[name] for it in iterates]).mean(dim=0)
        torch.testing.assert_close(astate.avg_params[name], want,
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge", "hinge"])
@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_mean_loss_with_preds_matches_reference(loss, l2):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(50, 1)).astype(np.float32)
    labels = rng.integers(0, 2, size=50).astype(np.int32)
    p = {"table": rng.normal(size=(4, 4, 1)).astype(np.float32),
         "bias": np.float32([0.3])}
    j_l, j_pred = jlosses.mean_loss_with_preds_fn(
        lambda prm, x: x, loss, l2)(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(logits),
        jnp.asarray(labels))
    t_fn = tlosses.mean_loss_with_preds_fn(lambda prm, x: x, loss, l2)
    t_l, t_pred = t_fn({n: torch.tensor(v) for n, v in p.items()},
                       torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(float(t_l), float(j_l), rtol=1e-6)
    assert np.array_equal(t_pred.numpy(), np.asarray(j_pred))
    assert float(tlosses.mean_loss_fn(lambda prm, x: x, loss, l2)(
        {n: torch.tensor(v) for n, v in p.items()}, torch.tensor(logits),
        torch.tensor(labels))) == float(t_l)


def test_softmax_loss_with_preds_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(40, 4)).astype(np.float32)
    labels = rng.integers(0, 4, size=40).astype(np.int32)
    j_l, j_pred = jlosses.mean_loss_with_preds_fn(lambda prm, x: x,
                                                  "softmax")(
        {}, jnp.asarray(logits), jnp.asarray(labels))
    t_l, t_pred = tlosses.mean_loss_with_preds_fn(lambda prm, x: x,
                                                  "softmax")(
        {}, torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(float(t_l), float(j_l), rtol=1e-6)
    assert np.array_equal(t_pred.numpy(), np.asarray(j_pred))


def test_tree_leaves_follow_the_reference_order():
    from repro.train.steps import (AveragedTrainState as JAvg,
                                   TrainState as JState)
    from repro_torch.train.steps import AveragedTrainState, TrainState

    def build(state_cls, avg_cls, leaf):
        return {"z": avg_cls(state_cls({"table": leaf(1), "bias": leaf(2)},
                                       {"v": {"table": leaf(3)},
                                        "m": {"table": leaf(4)}}, leaf(5)),
                             {"table": leaf(6), "bias": leaf(7)}, leaf(8)),
                "a": leaf(9), "m": (leaf(10), None, [leaf(11)])}

    want = jax.tree.leaves(build(JState, JAvg, lambda i: np.int64(i)))
    t = build(TrainState, AveragedTrainState, lambda i: np.int64(i))
    assert tree.leaves(t) == want
    back = tree.unflatten(t, [x * 10 for x in tree.leaves(t)])
    assert tree.leaves(back) == [x * 10 for x in want]
    assert isinstance(back["z"], AveragedTrainState)
    with pytest.raises(ValueError, match="fewer leaves"):
        tree.unflatten(t, want[:-1])
    with pytest.raises(ValueError, match="more leaves"):
        tree.unflatten(t, want + [0])


def test_trees_bitwise_equal_and_batched_accuracy():
    a = {"w": torch.arange(4, dtype=torch.float32), "b": np.ones(2)}
    assert trees_bitwise_equal(a, {"w": np.arange(4, dtype=np.float32),
                                   "b": torch.ones(2, dtype=torch.float64)})
    assert not trees_bitwise_equal(a, {"w": torch.zeros(4), "b": np.ones(2)})
    assert not trees_bitwise_equal(a, {"w": torch.zeros(4)})
    x = np.arange(10)
    labels = (x % 2).astype(np.int32)
    assert batched_accuracy(lambda v: v % 2, x, labels, batch=3) == 1.0
    assert batched_accuracy(lambda v: torch.zeros(len(v)), x, labels,
                            batch=4) == 0.5


# -------------------------------------------------------------- archives --
SCHEMES = [("minwise", 64, 8), ("oph", 64, 8), ("oph_zero", 32, 6)]


@pytest.fixture(scope="module")
def scheme_archives(corpus, tmp_path_factory):
    """{scheme: (reference's archive, port's archive)} of 200 rows in 3
    shards, both written with the same settings."""
    rows, labels = corpus
    out = {}
    for scheme, k, b in SCHEMES:
        d = tmp_path_factory.mktemp(scheme)
        ref, port = str(d / "ref"), str(d / "port")
        kw = dict(k=k, b=b, scheme=scheme, n_shards=3, seed=1, chunk=64)
        jhd.preprocess_and_save(ref, rows[:200], labels[:200], **kw)
        thd.preprocess_and_save(port, rows[:200], labels[:200],
                                device="cpu", **kw)
        out[scheme] = (ref, port)
    return out


@pytest.mark.parametrize("scheme", [s for s, _, _ in SCHEMES])
def test_archives_are_byte_equal(scheme, scheme_archives):
    ref, port = scheme_archives[scheme]
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port))
    assert any(n.endswith(".empty.npy") for n in names) == (
        scheme == "oph_zero")
    for name in names:
        if name.endswith(".npy"):
            with open(os.path.join(ref, name), "rb") as f1, \
                    open(os.path.join(port, name), "rb") as f2:
                assert f1.read() == f2.read(), name
    metas = []
    for d in (ref, port):
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        for timing in ("seconds_hashing", "mnnz_per_s"):
            meta.pop(timing)
        metas.append(meta)
    assert metas[0] == metas[1]
    assert metas[1]["format_version"] == thd.FORMAT_VERSION == 4


def _read_all(hd, root):
    codes, labels, meta = hd.load_hashed(root)
    batches = [(pk.copy(), lb.copy(), rid.copy(),
                None if em is None else em.copy())
               for pk, lb, rid, em in hd.iter_hashed_batches(
                   root, 16, perm_seed=(3, 1))]
    sub_codes, sub_labels, _ = hd.load_hashed(root, shard_ids=[1])
    checks = [hd.verify_shard(root, s) for s in range(meta["shards"])]
    return (codes, labels, batches, hd.shard_row_counts(root), sub_codes,
            sub_labels, checks)


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict) or a is None or isinstance(a, int):
        assert a == b
    else:
        assert np.array_equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("scheme", [s for s, _, _ in SCHEMES])
def test_archives_read_across_packages(scheme, scheme_archives):
    """Each package reads the other's archive as it reads its own."""
    ref, port = scheme_archives[scheme]
    for root in (ref, port):
        _same(_read_all(thd, root), _read_all(jhd, root))
    _same(_read_all(thd, port), _read_all(jhd, ref))


@pytest.mark.parametrize("scheme,b", [("minwise", 4), ("oph_zero", 6)])
def test_v2_archives_read_across_packages(scheme, b, archives, tmp_path):
    _, _, codes, labels = archives
    codes = codes[:90] & ((1 << b) - 1)
    if scheme == "oph_zero":
        codes = codes.copy()
        codes[::7, ::5] = thd.OPH_EMPTY_CODE
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    jhd.save_hashed(ref, codes, labels[:90], K, b, scheme=scheme,
                    n_shards=4)
    thd.save_hashed(port, codes, labels[:90], K, b, scheme=scheme,
                    n_shards=4)
    for s in range(4):
        with np.load(os.path.join(ref, f"hashed_{s:05d}.npz")) as z1, \
                np.load(os.path.join(port, f"hashed_{s:05d}.npz")) as z2:
            assert sorted(z1.files) == sorted(z2.files)
            for name in z1.files:
                assert np.array_equal(z1[name], z2[name])
    for root in (ref, port):
        got = thd.load_hashed(root)
        assert np.array_equal(got[0], codes)
        assert np.array_equal(got[1], labels[:90])
        _same(_read_all(thd, root), _read_all(jhd, root))


def test_stream_encoded_depths_give_the_same_bytes(corpus, monkeypatch):
    rows, _ = corpus
    dev = torch.device("cpu")
    for scheme, packed in (("oph_zero", True), ("oph_zero", False),
                           ("minwise", True)):
        runs = []
        for depth in (1, 2, 3):
            monkeypatch.setattr(thd, "PIPELINE_DEPTH", depth)
            runs.append(list(thd._stream_encoded(
                rows[:300], 32, 4, scheme=scheme, family="multiply_shift",
                seed=2, chunk=64, packed=packed, dev=dev)))
        for other in runs[1:]:
            _same([list(ev) for ev in runs[0]], [list(ev) for ev in other])


def test_iter_hashed_batches_rejects_batch_larger_than_shard(archives):
    _, port, _, _ = archives                   # 5 shards × 80 rows
    with pytest.raises(ValueError, match="exceeds shard"):
        next(iter(thd.iter_hashed_batches(port, 81)))
    with pytest.raises(ValueError, match="lower batch_size"):
        fit_streaming(port, LCFG, batch_size=81, device="cpu")
    batches = list(thd.iter_hashed_batches(port, 80))
    assert len(batches) == 5 and all(len(b[1]) == 80 for b in batches)
    assert len(list(thd.iter_hashed_batches(port, 48,
                                            drop_remainder=True))) == 5


# ------------------------------------------------------------- training --
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_bbit_sgd_matches_reference(optimizer, archives,
                                          reference_start):
    _, _, codes, labels = archives
    kw = dict(epochs=2, batch_size=64, lr=5e-3, optimizer=optimizer)
    want = j_train_bbit_sgd(codes[:N_TR], labels[:N_TR], codes[N_TR:],
                            labels[N_TR:], JCfg(k=K, b=B), **kw)
    got = train_bbit_sgd(codes[:N_TR], labels[:N_TR], codes[N_TR:],
                         labels[N_TR:], LCFG, device="cpu", **kw)
    _close(got.params, want.params, **TOL[optimizer])
    assert got.n_iter == want.n_iter == 2 * 7
    assert got.test_acc == want.test_acc
    assert got.train_acc == want.train_acc
    with pytest.raises(ValueError, match="epochs"):
        train_bbit_sgd(codes[:8], labels[:8], codes[:8], labels[:8], LCFG,
                       epochs=0, device="cpu")


@pytest.mark.parametrize("optimizer,scheme", [
    ("sgd", "minwise"), ("adamw", "minwise"), ("adamw", "oph_zero")])
def test_fit_streaming_matches_reference(optimizer, scheme, archives,
                                         scheme_archives, reference_start):
    """The port's fit over its archive against the reference's over its
    own: the same steps, rows and progressive accuracy, params and
    average allclose."""
    if scheme == "minwise":
        ref, port, k, b = archives[0], archives[1], K, B
    else:
        (ref, port), k, b = scheme_archives[scheme], 32, 6
    kw = dict(FIT_KW, optimizer=optimizer)
    want = j_fit_streaming(ref, JCfg(k=k, b=b), **kw)
    got = fit_streaming(port, BBitLinearConfig(k=k, b=b), device="cpu", **kw)
    assert (got.n_steps, got.examples_seen, got.shards_processed) == (
        want.n_steps, want.examples_seen, want.shards_processed)
    assert got.progressive_acc == want.progressive_acc
    assert got.completed and want.completed
    _close(got.params, want.params, **TOL[optimizer])
    _close(got.avg_params, want.avg_params, **TOL[optimizer])


def test_fit_streaming_resume_is_bitwise(archives, tmp_path):
    port = archives[1]
    kw = dict(FIT_KW, seed=3)
    straight = fit_streaming(port, LCFG, device="cpu", **kw)
    ck = str(tmp_path / "ck")
    part = fit_streaming(port, LCFG, ckpt_dir=ck, stop_after_shards=3,
                         device="cpu", **kw)
    assert not part.completed and part.shards_processed == 3
    resumed = fit_streaming(port, LCFG, ckpt_dir=ck, device="cpu", **kw)
    assert resumed.completed and resumed.shards_processed == 10
    assert trees_bitwise_equal(straight.params, resumed.params)
    assert trees_bitwise_equal(straight.avg_params, resumed.avg_params)
    assert straight.n_steps == resumed.n_steps
    assert straight.examples_seen == resumed.examples_seen
    assert straight.progressive_acc == resumed.progressive_acc


def test_fit_streaming_prefetch_depths_are_bitwise(archives, tmp_path):
    port = archives[1]
    kw = dict(FIT_KW, seed=7)
    inline = fit_streaming(port, LCFG, prefetch=0, device="cpu", **kw)
    for depth in (1, 2, 3):
        pf = fit_streaming(port, LCFG, prefetch=depth, device="cpu", **kw)
        assert trees_bitwise_equal(inline.params, pf.params), depth
        assert trees_bitwise_equal(inline.avg_params, pf.avg_params), depth
        assert (pf.n_steps, pf.examples_seen, pf.progressive_acc) == (
            inline.n_steps, inline.examples_seen, inline.progressive_acc)
    # a run killed under one depth resumes under another
    ck = str(tmp_path / "ck")
    fit_streaming(port, LCFG, ckpt_dir=ck, stop_after_shards=3, prefetch=0,
                  device="cpu", **kw)
    resumed = fit_streaming(port, LCFG, ckpt_dir=ck, prefetch=2,
                            device="cpu", **kw)
    assert trees_bitwise_equal(inline.params, resumed.params)
    assert trees_bitwise_equal(inline.avg_params, resumed.avg_params)


def test_fit_streaming_starts_from_the_seeded_draw(archives):
    """The start is a CPU generator's draw of ``seed``: the same on any
    device; the averaging window and ``average=False`` as the
    reference's."""
    port = archives[1]
    start = linear_trainer._initial_params(LCFG, 5, "cpu")
    again = tlinear.init_bbit_linear(
        LCFG, torch.Generator().manual_seed(5), device="cpu")
    assert trees_bitwise_equal(start, again)
    assert float(start["table"].std()) > 0 and not start["bias"].any()
    res = fit_streaming(port, LCFG, average=False, device="cpu",
                        **dict(FIT_KW, epochs=1))
    assert res.avg_params is None and res.eval_params is res.params
    late = fit_streaming(port, LCFG, avg_start_frac=0.9, device="cpu",
                         **dict(FIT_KW, epochs=1))
    assert late.eval_params is late.avg_params


def test_fit_streaming_rejects_incompatible_checkpoint(archives, tmp_path):
    port = archives[1]
    ck = str(tmp_path / "ck")
    fit_streaming(port, LCFG, epochs=1, batch_size=64, optimizer="adamw",
                  ckpt_dir=ck, stop_after_shards=2, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        fit_streaming(port, LCFG, epochs=1, batch_size=64, optimizer="sgd",
                      ckpt_dir=ck, device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        fit_streaming(port, LCFG, epochs=1, batch_size=32,
                      optimizer="adamw", ckpt_dir=ck, device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        fit_streaming(port, BBitLinearConfig(k=K, b=B, normalize=True),
                      epochs=1, batch_size=64, optimizer="adamw",
                      ckpt_dir=ck, device="cpu")
    with pytest.raises(ValueError, match="already holds checkpoints"):
        fit_streaming(port, LCFG, epochs=1, batch_size=64,
                      optimizer="adamw", ckpt_dir=ck, resume=False,
                      device="cpu")


def test_fit_streaming_rejects_mismatched_config_and_empty_archive(
        archives, tmp_path):
    port = archives[1]
    with pytest.raises(ValueError, match="does not match archive"):
        fit_streaming(port, BBitLinearConfig(k=32, b=8), device="cpu")
    e = str(tmp_path / "empty")
    thd.preprocess_and_save(e, [], np.zeros((0,), np.int32), k=16, b=8,
                            device="cpu")
    with pytest.raises(ValueError, match="empty archive"):
        fit_streaming(e, BBitLinearConfig(k=16, b=8), device="cpu")
    with pytest.raises(ValueError, match="ckpt_every_shards"):
        fit_streaming(port, LCFG, ckpt_dir=str(tmp_path / "x"),
                      ckpt_every_shards=0, device="cpu")
    with pytest.raises(ValueError, match="binary-only"):
        fit_streaming(port, BBitLinearConfig(k=K, b=B, n_classes=4),
                      loss="logistic", device="cpu")
    with pytest.raises(ValueError, match="needs n_classes > 2"):
        fit_streaming(port, LCFG, loss="softmax", device="cpu")
    with pytest.raises(ValueError, match="stop_after_shards"):
        fit_streaming(port, LCFG, stop_after_shards=2, device="cpu")
    with pytest.raises(ValueError, match="prefetch"):
        fit_streaming(port, LCFG, prefetch=-1, device="cpu")


def test_fit_streaming_softmax_multiclass(corpus, tmp_path):
    """A 4-class archive trains with softmax through the packed path."""
    rows, _ = corpus
    labels = np.arange(160, dtype=np.int32) % 4
    root = str(tmp_path / "mc")
    thd.preprocess_and_save(root, rows[:160], labels, k=16, b=4,
                            n_shards=2, device="cpu")
    res = fit_streaming(root, BBitLinearConfig(k=16, b=4, n_classes=4),
                        loss="softmax", batch_size=32, device="cpu")
    assert res.completed and res.params["table"].shape == (16, 16, 4)
    assert res.n_steps == 6 and res.examples_seen == 160


def test_threaded_prefetcher_propagates_errors_and_closes():
    def boom():
        yield 1
        yield 2
        raise RuntimeError("producer exploded")

    pf = ThreadedPrefetcher(boom(), depth=2)
    assert next(pf) == 1 and next(pf) == 2
    with pytest.raises(RuntimeError, match="producer exploded"):
        next(pf)
    pf.close()

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = ThreadedPrefetcher(endless(), depth=1)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
    with pytest.raises(ValueError, match="depth"):
        ThreadedPrefetcher(iter([]), depth=0)


def test_stream_kwargs_of_the_config_drive_the_port(archives):
    from repro.configs.rcv1_oph import CONFIG as J_CONFIG
    from repro_torch.configs.rcv1_oph import CONFIG
    assert CONFIG.linear_config() == BBitLinearConfig(k=256, b=8)
    assert CONFIG.stream_kwargs() == J_CONFIG.stream_kwargs()
    assert (CONFIG.stream_procs, CONFIG.ft_barrier_timeout_s) == (
        J_CONFIG.stream_procs, J_CONFIG.ft_barrier_timeout_s)
    assert CONFIG.restart_policy() == dataclasses_as_port(
        J_CONFIG.restart_policy())
    res = fit_streaming(archives[1], LCFG, device="cpu",
                        **CONFIG.stream_kwargs(batch_size=64))
    assert res.completed and res.n_steps == 10


def dataclasses_as_port(policy):
    from repro_torch.ft.retry import BackoffPolicy
    from repro_torch.train.supervisor import RestartPolicy
    b = policy.backoff
    return RestartPolicy(max_restarts=policy.max_restarts,
                         backoff=BackoffPolicy(b.base_s, b.factor, b.cap_s,
                                               b.jitter_frac, b.seed))
