"""The port's cost model (``perf/``) against the reference's contract
(``tests/test_dispatch.py``'s 15 cases, mapped onto the port's arms
``kernel`` and ``plain``).

The port's eligibility is its own: on a CUDA device the kernel arm
within its kernel's limits and the plain arm only outside them; on the
CPU the plain arm only.  ``choose`` takes the device type, so the card's
choices are checked here without a card (no tensor is made on it).  No
profile, env var or pin puts a plain version on the card; with no
profile every choice is the static rule; a profile of the JAX package is
rejected by its fingerprint; ``use_kernel='never'`` on the card raises.
Results of forced arms are the reference's: encodes byte for byte,
logits allclose at the reference's kernel tolerance (1e-4)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import perf as jperf
from repro.core.bbit import pack_codes
from repro.core.schemes import make_scheme as j_make_scheme
from repro.models.linear import BBitLinearConfig as JCfg
from repro.models.linear import bbit_logits as j_bbit_logits
from repro.models.linear import init_bbit_linear as j_init

from repro_torch import perf
from repro_torch.core.schemes import make_scheme
from repro_torch.kernels import ops
from repro_torch.models.linear import (BBitLinearConfig, bbit_logits,
                                       bbit_logits_packed, init_bbit_linear,
                                       logits_impl, logits_packed_impl,
                                       params_from_jax)
from repro_torch.perf import (BBIT_KERNEL_MAX_V, CostTable, ProfileError,
                              device_fingerprint)
from repro_torch.perf.cost_model import OPS, shape_bucket

CALIBRATED = ("encode", "encode_packed", "logits", "logits_packed",
              "hamming_topk")


@pytest.fixture(autouse=True)
def _clean_dispatch(monkeypatch):
    monkeypatch.delenv(perf.ENV_DISPATCH, raising=False)
    monkeypatch.delenv(perf.ENV_PROFILE, raising=False)
    perf.reset()
    yield
    perf.reset()


def _encode_case(scheme, b, k=16, rows=5, width=12, seed=0):
    rng = np.random.default_rng(seed * 331 + b)
    idx = rng.integers(0, 1 << 30, size=(rows, width)).astype(np.int32)
    nnz = rng.integers(1, width + 1, size=(rows,)).astype(np.int32)
    return idx, nnz


# ---------------------------------------------------------------------------
# no profile, no overrides ⇒ the static rule


def test_no_profile_reproduces_static_policy():
    shape = {"scheme": "oph", "k": 16, "b": 8, "v": 256, "rows": 64,
             "nnz": 128, "width": 16}
    for op in ("encode", "encode_packed", "logits", "logits_packed",
               "logits_bwd", "logits_packed_bwd", "hamming_topk"):
        assert perf.choose(op, shape, device="cuda") == "kernel", op
        assert perf.choose(op, shape, device="cpu") == "plain", op
        assert perf.choose(op, shape) == "plain", op       # default: CPU
    assert perf.choose("serve_score", shape) == "fused"
    assert "pallas_mode" not in OPS            # no counterpart
    rep = perf.dispatch_report()
    assert rep["profile_loaded"] is False and rep["hits"] == 0
    assert rep["fallbacks"] == 22 and rep["overrides"] == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 6, 8, 12, 15, 16])
def test_no_profile_choices_equal_todays_rules(device, b):
    """Every op's choice without a profile: the kernel exactly where
    ``kernels/ops.py``'s rule launches one (on the card, within the
    kernel's limits: B1 any b ≤ 16, B2/B5/B6 whole-byte b, B3/B4/B7/B8/
    B10 any b), else the plain version."""
    card = device == "cuda"
    whole = b in ops.PACK_BITS
    rule = {
        ("encode", "minwise"): True, ("encode", "oph"): True,
        ("encode_packed", "minwise"): True,
        ("encode_packed", "oph"): whole, ("encode_packed", "oph_zero"): whole,
        ("logits", None): True, ("logits_bwd", None): True,
        ("logits_packed", None): whole, ("logits_packed_bwd", None): whole,
        ("hamming_topk", None): True,
    }
    for (op, scheme), kernel_ok in rule.items():
        shape = {"k": 64, "b": b, "v": 1 << b, "rows": 8, "nnz": 100}
        if scheme is not None:
            shape["scheme"] = scheme
        want = "kernel" if card and kernel_ok else "plain"
        assert perf.choose(op, shape, device=device) == want, (op, scheme)
    assert perf.dispatch_report()["fallbacks"] == len(rule)


def test_eligibility_filters_before_any_override():
    cuda = "cuda"
    assert OPS["encode_packed"].eligible(
        {"scheme": "oph", "k": 16, "b": 3}, cuda) == ("plain",)
    assert OPS["encode_packed"].eligible(
        {"scheme": "minwise", "k": 16, "b": 3}, cuda) == ("kernel",)
    assert OPS["encode_packed"].eligible(
        {"scheme": "minwise", "k": 16, "b": 17}, cuda) == ("plain",)
    assert OPS["logits"].eligible({"v": BBIT_KERNEL_MAX_V * 2},
                                  cuda) == ("plain",)
    assert OPS["logits"].eligible({"v": 1 << 16}, cuda) == ("kernel",)
    assert OPS["logits_packed"].eligible({"b": 6}, cuda) == ("plain",)
    for op in CALIBRATED:
        assert OPS[op].eligible({"b": 8, "scheme": "oph"}, "cpu") == (
            "plain",)
    # pinning the ineligible arm is ignored, not crashed into: no pin puts
    # a plain version on the card, nor a kernel on the CPU
    assert perf.choose("encode_packed", {"scheme": "oph", "k": 16, "b": 3},
                       device=cuda, impl="kernel") == "plain"
    with perf.forced(logits="plain"):
        assert perf.choose("logits", {"v": 1 << 16}, device=cuda) == "kernel"
    with perf.forced(logits="kernel"):
        assert perf.choose("logits", {"v": 256}, device="cpu") == "plain"
    assert perf.dispatch_report()["ineligible_overrides"] == 1
    with pytest.raises(ValueError, match="no kernel"):
        perf.choose("logits", {"v": 256}, device="meta")
    with pytest.raises(KeyError):
        with perf.forced(pallas_mode="compiled"):
            pass


# ---------------------------------------------------------------------------
# forced arms give the reference's results


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_forced_encode_impls_bitwise_identical(scheme, b):
    idx, nnz = _encode_case(scheme, b)
    sch = make_scheme(scheme, 16, 0)
    ti, tn = torch.from_numpy(idx), torch.from_numpy(nnz)

    def _run():
        packed, p_empty = sch.encode_packed(ti, tn, b)
        codes, c_empty = sch.encode_device(ti, tn, b)
        return [None if x is None else x.numpy()
                for x in (packed, p_empty, codes, c_empty)]

    jsch = j_make_scheme(scheme, 16, 0)
    jp, jpe = jsch.encode_packed_device(jnp.asarray(idx), jnp.asarray(nnz), b)
    jc, jce = jsch.encode_device(jnp.asarray(idx), jnp.asarray(nnz), b)
    want = [None if x is None else np.asarray(x) for x in (jp, jpe, jc, jce)]
    with perf.forced(encode_packed="kernel", encode="kernel"):
        kernel_pin = _run()
    with perf.forced(encode_packed="plain", encode="plain"):
        plain_pin = _run()
    for got_k, got_p, w in zip(kernel_pin, plain_pin, want):
        if w is None:
            assert got_k is None and got_p is None
        else:
            assert np.array_equal(got_k, got_p)
            assert np.array_equal(got_k, w.astype(got_k.dtype))
    # the CPU ran the plain arm both times: the kernel pins were passed
    # over (static rule), the plain pins counted as overrides
    rep = perf.dispatch_report()
    assert rep["overrides"] == 2 and rep["fallbacks"] == 2


@pytest.mark.parametrize("b", [2, 4, 8])
def test_forced_logits_impls_agree(b):
    k, v, rows = 16, 1 << b, 9
    jp = j_init(JCfg(k=k, b=b), jax.random.key(b))
    params = params_from_jax({n: np.asarray(x) for n, x in jp.items()},
                             device="cpu")
    cfg = BBitLinearConfig(k=k, b=b)
    rng = np.random.default_rng(b)
    codes = rng.integers(0, v, size=(rows, k)).astype(np.uint16)
    wide = torch.from_numpy(codes.astype(np.int32))
    packed = torch.from_numpy(pack_codes(codes, b))
    want = np.asarray(j_bbit_logits(jp, jnp.asarray(codes.astype(np.int32)),
                                    JCfg(k=k, b=b)))
    with perf.forced(logits="kernel", logits_packed="kernel"):
        lk = bbit_logits(params, wide, cfg).numpy()
        pk = bbit_logits_packed(params, packed, cfg).numpy()
    with perf.forced(logits="plain", logits_packed="plain"):
        lg = bbit_logits(params, wide, cfg).numpy()
        pu = bbit_logits_packed(params, packed, cfg).numpy()
    np.testing.assert_allclose(lk, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pk, want, rtol=1e-4, atol=1e-4)
    # the CPU takes the plain versions under either pin
    assert np.array_equal(lk, lg) and np.array_equal(pk, pu)


def test_use_kernel_config_maps_to_explicit_impl():
    cfg_never = BBitLinearConfig(k=16, b=8, use_kernel="never")
    cfg_always = BBitLinearConfig(k=16, b=8, use_kernel="always")
    assert logits_impl(cfg_never) == "plain"
    assert logits_packed_impl(cfg_never) == "plain"
    assert logits_impl(cfg_always, device="cuda") == "kernel"
    assert logits_packed_impl(cfg_always, device="cuda") == "kernel"
    # 'always' on the CPU: the kernel arm is not eligible there
    assert logits_impl(cfg_always) == "plain"
    # explicit config beats a forced context and the env var
    with perf.forced(logits="kernel"):
        assert logits_impl(cfg_never) == "plain"
    os.environ[perf.ENV_DISPATCH] = "logits_packed=kernel"
    try:
        assert logits_packed_impl(cfg_never) == "plain"
    finally:
        del os.environ[perf.ENV_DISPATCH]
    # a b whose packed codes straddle bytes: plain is the card's only arm,
    # so 'never' is allowed there
    assert logits_packed_impl(BBitLinearConfig(k=16, b=6, use_kernel="never"),
                              device="cuda") == "plain"


def test_use_kernel_never_refused_on_the_card():
    """``use_kernel='never'`` on a CUDA device whose kernel applies raises
    a ValueError saying why; so does a scheme's ``use_kernel=False``."""
    cfg = BBitLinearConfig(k=500, b=16, use_kernel="never")
    for fn in (logits_impl, logits_packed_impl):
        shape_ok = fn is logits_impl or cfg.b in ops.PACK_BITS
        if shape_ok:
            with pytest.raises(ValueError,
                               match="never runs a plain version on the "
                                     "card"):
                fn(cfg, rows=4, device="cuda")
    with pytest.raises(ValueError, match="use_kernel='never'"):
        logits_impl(BBitLinearConfig(k=16, b=8, use_kernel="never"),
                    device="cuda")
    idx = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    sch = make_scheme("minwise", 16, 0)
    with pytest.raises(ValueError, match="use_kernel=False"):
        perf.refuse_plain_on_card("encode_packed",
                                  sch._encode_shape(idx, 16), "cuda",
                                  "minwise encode(use_kernel=False)")
    # the CPU takes the plain arm either way
    idx, nnz = _encode_case("minwise", 8)
    got, _ = sch.encode_packed(torch.from_numpy(idx), torch.from_numpy(nnz),
                               8, use_kernel=False)
    want, _ = sch.encode_packed(torch.from_numpy(idx), torch.from_numpy(nnz),
                                8)
    assert torch.equal(got, want)


def test_env_dispatch_and_precedence(monkeypatch):
    shape = {"k": 16, "b": 8, "v": 256}
    monkeypatch.setenv(perf.ENV_DISPATCH,
                       "logits=kernel, logits_packed=kernel")
    assert perf.choose("logits", shape, device="cuda") == "kernel"
    assert perf.choose("logits_packed", shape, device="cuda") == "kernel"
    # forced context beats env; explicit impl beats both; an ineligible
    # pin (plain on the card) is passed over for the next in line
    with perf.forced(logits="kernel"):
        assert perf.choose("logits", shape, device="cuda") == "kernel"
        assert perf.choose("logits", shape, device="cuda",
                           impl="kernel") == "kernel"
    with perf.forced(logits="plain"):
        assert perf.choose("logits", shape, device="cuda") == "kernel"
    monkeypatch.setenv(perf.ENV_DISPATCH, "logits=plain")
    assert perf.choose("logits", shape, device="cpu") == "plain"
    rep = perf.dispatch_report()
    assert rep["overrides"] == 6 and rep["fallbacks"] == 0
    assert rep["choices"]["logits|b=8,k=16,v=256"] == "plain"


# ---------------------------------------------------------------------------
# profiles: round-trip, rejection, decisions


def _table(entries, fp=None, version="t1"):
    return CostTable(fingerprint=fp or device_fingerprint(),
                     entries=dict(entries), table_version=version)


def test_profile_roundtrip_identical_decisions(tmp_path):
    shape = {"k": 16, "b": 8, "v": 256, "rows": 64}
    enc = {"scheme": "oph", "k": 16, "b": 8, "rows": 64, "nnz": 128}
    table = _table({
        CostTable.key("logits", "plain", shape_bucket(shape)): 0.002,
        CostTable.key("logits", "kernel", shape_bucket(shape)): 0.005,
        CostTable.key("encode_packed", "plain", shape_bucket(enc)): 0.001,
    })
    path = str(tmp_path / "profile.json")
    table.save(path)
    loaded = CostTable.load(path)
    assert loaded.entries == table.entries
    assert loaded.table_version == table.table_version

    perf.set_profile(table)
    first = (perf.choose("logits", shape), perf.choose("encode_packed", enc))
    perf.reset()
    assert perf.maybe_load_profile(path) is True
    second = (perf.choose("logits", shape), perf.choose("encode_packed", enc))
    assert first == second == ("plain", "plain")
    rep = perf.dispatch_report()
    assert rep["profile_loaded"] and rep["hits"] == 2
    assert rep["table_version"] == "t1"
    # a profile cannot put the plain arm on the card: there only the
    # kernel is eligible, and its measured entry decides
    assert perf.choose("logits", shape, device="cuda") == "kernel"
    assert perf.dispatch_report()["hits"] == 3


def test_partial_profile_falls_back_to_heuristic():
    shape = {"k": 16, "b": 8, "v": 256, "rows": 64}
    # only the card's arm measured ⇒ no profile decision on the CPU
    perf.set_profile(_table({
        CostTable.key("logits", "kernel", shape_bucket(shape)): 0.001}))
    assert perf.choose("logits", shape) == "plain"
    rep = perf.dispatch_report()
    assert rep["hits"] == 0 and rep["fallbacks"] == 1


def test_profile_never_flips_uncalibrated_ops():
    shape = {"k": 16, "b": 8, "v": 256, "rows": 64}
    bucket = shape_bucket(shape)
    perf.set_profile(_table({
        CostTable.key("logits_bwd", "kernel", bucket): 9.0,
        CostTable.key("logits_bwd", "plain", bucket): 0.1}))
    assert perf.choose("logits_bwd", shape, device="cuda") == "kernel"
    assert perf.choose("logits_bwd", shape) == "plain"
    assert perf.dispatch_report()["hits"] == 0


def test_corrupt_and_mismatched_profiles_rejected(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(ProfileError):
        CostTable.load(str(bad))
    wrong_schema = tmp_path / "schema.json"
    wrong_schema.write_text(json.dumps({"schema": 999, "entries": {},
                                        "fingerprint": {}}))
    with pytest.raises(ProfileError):
        CostTable.load(str(wrong_schema))
    alien = tmp_path / "alien.json"
    other = _table({}, fp={"backend": "cuda", "device_kind": "NVIDIA A100",
                           "device_count": 8, "torch": torch.__version__})
    other.save(str(alien))
    with pytest.raises(ProfileError, match="does not match"):
        perf.set_profile(str(alien), strict=True)
    # launchers degrade instead of crashing
    for p in (bad, wrong_schema, alien):
        with pytest.warns(UserWarning, match="ignoring profile"):
            assert perf.maybe_load_profile(str(p)) is False
    assert perf.maybe_load_profile(str(tmp_path / "missing.json")) is False
    assert perf.dispatch_report()["profile_loaded"] is False


def test_jax_package_profile_rejected_by_fingerprint(tmp_path):
    """A profile the JAX package wrote on this very box (its fingerprint
    names jax, not torch) is rejected, by set_profile, by
    maybe_load_profile and through REPRO_PROFILE."""
    jtable = jperf.CostTable(fingerprint=jperf.device_fingerprint(),
                             entries={"logits|gather|-": 0.1},
                             table_version="jax-v1")
    path = str(tmp_path / "jax_profile.json")
    jtable.save(path)
    loaded = CostTable.load(path)          # the schema is shared
    assert loaded.entries == jtable.entries
    assert perf.fingerprint_key(loaded.fingerprint).startswith("jax|")
    assert not loaded.matches_device()
    with pytest.raises(ProfileError, match="jax"):
        perf.set_profile(path)
    with pytest.warns(UserWarning):
        assert perf.maybe_load_profile(path) is False
    os.environ[perf.ENV_PROFILE] = path
    try:
        perf.reset()
        with pytest.warns(UserWarning, match="REPRO_PROFILE"):
            assert perf.dispatch_report()["profile_loaded"] is False
    finally:
        del os.environ[perf.ENV_PROFILE]
    # and the port's own profile keys to this box
    fp = device_fingerprint()
    assert fp["torch"] == torch.__version__
    assert perf.fingerprint_key(fp) == (
        "cpu" if not torch.cuda.is_available()
        else f"cuda|{fp['device_kind']}|{fp['device_count']}|torch "
             f"{torch.__version__}")


def test_shape_bucketing_pow2_rounds_data_sizes():
    a = shape_bucket({"rows": 65, "nnz": 1000, "k": 200, "b": 8})
    assert a == "b=8,k=200,nnz=1024,rows=128"
    assert shape_bucket({"rows": 128, "nnz": 1024, "k": 200, "b": 8}) == a
    assert shape_bucket(None) == "-"
    for shape in ({"rows": 3, "width": 17, "m": 5, "scheme": "oph"}, {}):
        assert shape_bucket(shape) == jperf.shape_bucket(shape)


# ---------------------------------------------------------------------------
# micro-batch sizing off a serve_score curve


def _serve_table(curve_fn, nnz_buckets=(32,), k=16, b=8, scheme="minwise"):
    entries = {}
    for m in nnz_buckets:
        for r in (1, 2, 4, 8):
            entries[CostTable.key(
                "serve_score", "fused",
                shape_bucket({"scheme": scheme, "k": k, "b": b,
                              "rows": r, "nnz": m}))] = curve_fn(r)
    return _table(entries)


def test_row_bucket_suggestions_from_curve_shape():
    flat = _serve_table(lambda r: 1.0)
    assert perf.suggest_row_buckets(16, 8, "minwise", 8, (32,),
                                    table=flat) == {32: (8,)}
    assert perf.suggest_lane_caps(16, 8, "minwise", 8, (32,),
                                  table=flat) == {32: 8}
    linear = _serve_table(lambda r: float(r))
    assert perf.suggest_row_buckets(16, 8, "minwise", 8, (32,),
                                    table=linear) == {32: (1, 2, 4, 8)}
    assert perf.suggest_lane_caps(16, 8, "minwise", 8, (32,),
                                  table=linear) == {32: 8}
    convex = _serve_table(lambda r: {1: 1.0, 2: 2.5, 4: 6.0, 8: 16.0}[r])
    assert perf.suggest_lane_caps(16, 8, "minwise", 8, (32,),
                                  table=convex) == {32: 1}
    assert perf.suggest_row_buckets(16, 8, "minwise", 8, (32, 64),
                                    table=flat) is None
    # the reference's functions on the same curves give the same answers
    for fn in (lambda r: 1.0, lambda r: float(r),
               lambda r: {1: 1.0, 2: 2.5, 4: 6.0, 8: 16.0}[r]):
        mine = _serve_table(fn)
        theirs = jperf.CostTable(fingerprint=jperf.device_fingerprint(),
                                 entries=dict(mine.entries))
        for name in ("suggest_row_buckets", "suggest_lane_caps"):
            assert (getattr(perf, name)(16, 8, "minwise", 8, (32,),
                                        table=mine)
                    == getattr(jperf, name)(16, 8, "minwise", 8, (32,),
                                            table=theirs))


def test_engine_consumes_profile_and_reports_dispatch():
    from repro_torch.serving import HashedClassifierEngine
    perf.set_profile(_serve_table(lambda r: 1.0))
    cfg = BBitLinearConfig(k=16, b=8)
    params = init_bbit_linear(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    eng = HashedClassifierEngine(params, cfg, seed=0, max_batch=8,
                                 max_wait_ms=1, nnz_buckets=(32,),
                                 row_buckets=None, device="cpu")
    try:
        st = eng.stats()
        assert st["lane_row_buckets"] == {"32": [8]}
        assert st["lane_caps"] == {"32": 8}
        assert st["row_buckets"] == [8]
        assert eng.batcher.lane_caps == {32: 8}
        assert st["dispatch"]["profile_loaded"] is True
        rng = np.random.default_rng(0)
        docs = [np.unique(rng.integers(0, 1 << 20, size=s))
                for s in (3, 20, 7)]
        scores = eng.score_docs(docs)
        assert scores.shape == (3,)
        futs = [eng.submit(d) for d in docs]
        eng.flush()
        assert np.array_equal(
            np.asarray([f.result(timeout=60) for f in futs], np.float32),
            scores)
        assert eng.stats()["dispatch"]["choices"]
    finally:
        eng.close()


def test_engine_without_profile_keeps_static_grid():
    from repro_torch.serving import HashedClassifierEngine
    cfg = BBitLinearConfig(k=16, b=8)
    params = init_bbit_linear(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    eng = HashedClassifierEngine(params, cfg, seed=0, max_batch=8,
                                 max_wait_ms=1, nnz_buckets=(32,),
                                 row_buckets=None, device="cpu")
    try:
        st = eng.stats()
        assert st["lane_row_buckets"] == {}
        assert st["lane_caps"] == {}
        assert st["row_buckets"] == [1, 2, 4, 8]
        assert st["dispatch"]["profile_loaded"] is False
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# calibration: budget-capped, deterministic, round-trippable


def test_calibrate_smoke_budget_and_roundtrip(tmp_path):
    table = perf.calibrate(k=16, b_values=(8,), schemes=("oph",),
                           encode_rows=(4,), encode_widths=(16,),
                           logits_rows=(8,), max_batch=4,
                           nnz_buckets=(16,), trials=1, budget_s=120.0,
                           seed=0, device="cpu")
    assert table.entries and table.matches_device()
    assert table.meta["n_entries"] == len(table.entries)
    per_bucket = {}
    for key in table.entries:
        op, impl, bucket = key.split("|", 2)
        per_bucket.setdefault((op, bucket), set()).add(impl)
    # every calibrated bucket holds its one eligible arm on this device
    for (op, bucket), impls in per_bucket.items():
        assert impls == ({"fused"} if op == "serve_score" else {"plain"})
    ops_seen = {op for op, _ in per_bucket}
    assert ops_seen == {"encode", "encode_packed", "logits",
                        "logits_packed", "hamming_topk", "serve_score"}
    path = str(tmp_path / "p.json")
    table.save(path)
    assert CostTable.load(path).entries == table.entries
    summary = perf.summarize(table)
    assert summary["entries"] == len(table.entries)
    assert set(summary["profile_picks"]) == ops_seen - {"serve_score"}
    # the serving grid's points are in the profile for the engine's own
    # dispatches: an engine at that grid reads hits
    perf.set_profile(table)
    assert perf.suggest_row_buckets(16, 8, "oph", 4, (16,)) is not None
    from repro_torch.serving import HashedClassifierEngine
    cfg = BBitLinearConfig(k=16, b=8)
    params = init_bbit_linear(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with HashedClassifierEngine(params, cfg, seed=0, scheme="oph",
                                max_batch=4, nnz_buckets=(16,),
                                row_buckets=None, device="cpu") as eng:
        eng.score_docs([np.arange(5), np.arange(9)])
        assert eng.stats()["dispatch"]["hits"] >= 2
    # an exhausted budget yields an empty (but valid, saveable) table
    empty = perf.calibrate(k=16, b_values=(8,), schemes=("oph",),
                           encode_rows=(4,), encode_widths=(16,),
                           logits_rows=(8,), nnz_buckets=(16,),
                           trials=1, budget_s=0.0, seed=0, device="cpu")
    assert empty.entries == {}
    perf.set_profile(empty)
    assert perf.choose("logits", {"k": 16, "b": 8, "v": 256}) == "plain"


def test_calibrate_launcher_writes_a_profile(tmp_path, capsys):
    from repro_torch.launch import calibrate as launch_cal
    out = str(tmp_path / "prof.json")
    assert launch_cal.main(["--device", "cpu", "--k", "16", "--budget-s",
                            "30", "--trials", "1", "--max-batch", "2",
                            "--out", out]) == 0
    text = capsys.readouterr().out
    assert "wrote" in text and out in text
    table = CostTable.load(out)
    assert table.matches_device() and table.entries
    assert table.meta["schemes"] == ["oph"] and table.meta["k"] == 16


def test_config_calibrate_fields_match_the_reference():
    from repro.configs.rcv1_oph import CONFIG as J
    from repro_torch.configs.rcv1_oph import CONFIG
    mine, theirs = CONFIG.calibrate_kwargs(), J.calibrate_kwargs()
    assert mine == theirs
    for name in ("calibrate_budget_s", "calibrate_trials",
                 "calibrate_max_batch", "calibrate_nnz_buckets"):
        assert getattr(CONFIG, name) == getattr(J, name)
    # the port's profile has a file of its own
    assert CONFIG.profile_path != J.profile_path


def test_param_dtype_bfloat16_raises_naming_its_item():
    cfg = BBitLinearConfig(k=16, b=8, param_dtype="bfloat16")
    with pytest.raises(ValueError, match="ROADMAP A7"):
        init_bbit_linear(cfg, device="cpu")
    params = init_bbit_linear(BBitLinearConfig(k=16, b=8), device="cpu")
    with pytest.raises(ValueError, match="float32 tables only"):
        bbit_logits(params, torch.zeros((2, 16), dtype=torch.int32), cfg)
    assert (dataclasses.asdict(BBitLinearConfig(k=3, b=4))
            == dataclasses.asdict(JCfg(k=3, b=4)))
    assert BBitLinearConfig(k=16, b=8).n_weights == JCfg(k=16, b=8).n_weights


def test_streaming_fit_records_its_dispatch(tmp_path):
    """fit_streaming records its packed-logits arm and the profile it read
    in the result and in every checkpoint's meta.json, and a profile
    loaded between a run and its resume does not break the resume."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.hashed_dataset import preprocess_and_save
    from repro_torch.train.streaming import fit_streaming
    rng = np.random.default_rng(0)
    rows = [np.unique(rng.integers(0, 1 << 20, size=int(s)))
            for s in rng.integers(5, 60, size=64)]
    labels = rng.integers(0, 2, size=64).astype(np.int32)
    root = str(tmp_path / "arch")
    preprocess_and_save(root, rows, labels, k=16, b=8, scheme="oph",
                        seed=1, n_shards=4, device="cpu")
    cfg = BBitLinearConfig(k=16, b=8)
    kw = dict(epochs=1, batch_size=8, ckpt_dir=str(tmp_path / "ck"),
              ckpt_every_shards=1, device="cpu", seed=0)
    half = fit_streaming(root, cfg, stop_after_shards=2, **kw)
    assert half.dispatch == {"logits_packed": "plain",
                             "table_version": None, "profile_loaded": False}
    meta = ckpt.load_meta(kw["ckpt_dir"], 2)
    assert meta["dispatch"] == half.dispatch
    perf.set_profile(_table({}, version="later"))
    rest = fit_streaming(root, cfg, **kw)
    assert rest.completed and rest.dispatch["table_version"] == "later"
    perf.reset()
    whole = fit_streaming(root, cfg, **dict(kw, ckpt_dir=None))
    for name in ("table", "bias"):
        assert torch.equal(rest.params[name], whole.params[name])


def test_launch_serve_with_a_profile(tmp_path, capsys):
    """``launch/serve.py --profile``: a usable profile sizes the engine's
    lanes from its curve; a JAX-package profile leaves the static pair."""
    from repro_torch.launch import serve as launch_serve
    path = str(tmp_path / "p.json")
    _serve_table(lambda r: float(r), nnz_buckets=(2048, 8192), k=16,
                 b=8).save(path)
    args = ["--device", "cpu", "--n-docs", "60", "--k", "16",
            "--requests", "20", "--max-batch", "8"]
    assert launch_serve.main(args + ["--profile", path]) == 0
    assert f"dispatch: cost-model profile {path}" in capsys.readouterr().out
    jpath = str(tmp_path / "j.json")
    jperf.CostTable(fingerprint=jperf.device_fingerprint()).save(jpath)
    perf.reset()
    with pytest.warns(UserWarning):
        assert launch_serve.main(args + ["--profile", jpath]) == 0
    assert "static rules" in capsys.readouterr().out
