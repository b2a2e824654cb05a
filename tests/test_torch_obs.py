"""The port's counters and spans (``repro_torch.obs``, read through
``kernels.ops.counts()``): tracing off moves no span and tracing on
changes no result, self time on a per-thread stack, the names
``counts()`` keeps and adds, a span as a host operation in a profile,
TRON's host reads and CG steps counted by hand, B8's plan cache counting
hits and builds; on the card, no program span mirrored on the device's
timeline.  Imports no JAX (the ``cuda`` test runs where only torch is
installed)."""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.core.schemes import make_scheme
from repro_torch.kernels import bbit_linear as bl
from repro_torch.kernels import ops
from repro_torch.models.linear import BBitLinearConfig
from repro_torch.optim.tron import tron_minimize
from repro_torch.train.linear_trainer import train_bbit_liblinear

SPANS = ("trainer.fit", "trainer.accuracy", "tron.minimize", "tron.iter",
         "tron.cg_step", "tron.read", "scheme.encode_packed",
         "dispatch.choose", "kernel.alloc")
KERNELS = ("minhash", "oph", "minhash_pack", "oph_pack",
           "bbit_linear_packed_fwd", "bbit_linear_packed_bwd_dw",
           "bbit_linear_fwd", "bbit_linear_bwd_dw", "vw_sketch",
           "hamming_distance")
BF16 = ("bbit_linear_packed_fwd", "bbit_linear_packed_bwd_dw",
        "bbit_linear_fwd", "bbit_linear_bwd_dw")
# the names ops.counts() had before obs, and what obs adds to them
OLD_NAMES = ({*KERNELS, *(f"{n}_bf16" for n in BF16),
              *(f"{n}_plain" for n in KERNELS), "bbit_linear_bwd_dw_plans"})
NEW_COUNTERS = ("bbit_linear_bwd_dw_plan_hits", "tron.host_reads",
                "tron.cg_steps", "trainer.h2d_bytes", "trainer.d2h_bytes",
                "trainer.curvature_builds", "trainer.curvature_hits",
                "bbit_linear_fwd_sliced")


@pytest.fixture
def tracing():
    obs.reset()
    obs.enable()
    try:
        yield
    finally:
        obs.enable(False)
        obs.reset()


def _spans():
    return {k: v for k, v in ops.counts().items() if k.startswith("span.")}


def _problem(seed, n=240, k=16, b=4):
    rng = np.random.default_rng(seed)
    proto = rng.integers(0, 1 << b, size=(2, k))
    y = rng.integers(0, 2, size=n).astype(np.int32)
    copy = rng.random((n, k)) < 0.4
    codes = np.where(copy, proto[y], rng.integers(0, 1 << b, size=(n, k)))
    return codes.astype(np.int32), y


def _fit(cfg):
    codes, y = _problem(3)
    return train_bbit_liblinear(codes[:200], y[:200], codes[200:], y[200:],
                                cfg, max_iter=20, device="cpu")


def test_tracing_off_moves_no_span_and_on_changes_no_result():
    cfg = BBitLinearConfig(k=16, b=4)
    ops.reset_counts()
    off = _fit(cfg)
    counts = ops.counts()
    assert all(v == 0 for v in _spans().values())
    assert counts["tron.host_reads"] > 0 and counts["tron.cg_steps"] > 0
    # a CPU fit moves nothing between host and card
    assert counts["trainer.h2d_bytes"] == counts["trainer.d2h_bytes"] == 0
    obs.enable()
    try:
        ops.reset_counts()
        on = _fit(cfg)
        spans = _spans()
    finally:
        obs.enable(False)
        ops.reset_counts()
    for name in ("table", "bias"):
        assert torch.equal(on.params[name], off.params[name])
    assert (on.n_iter, on.objective) == (off.n_iter, off.objective)
    assert (on.train_acc, on.test_acc) == (off.train_acc, off.test_acc)
    for name in ("trainer.fit", "trainer.accuracy", "tron.minimize"):
        assert spans[f"span.{name}.calls"] == 1, name
    assert spans["span.tron.iter.calls"] == off.n_iter
    assert spans["span.trainer.fit.ns"] >= spans["span.tron.minimize.ns"]


def test_nested_spans_self_time_on_two_threads(tracing):
    """Two threads interleave their spans (barriers): each outer span's
    self time is its total less its own child's, never the other
    thread's."""
    gate = threading.Barrier(2, timeout=30)

    def work(tag):
        with obs.span(f"{tag}.outer"):
            gate.wait()
            time.sleep(0.01)
            with obs.span(f"{tag}.inner"):
                gate.wait()
                time.sleep(0.02 if tag == "a" else 0.04)
            gate.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    got = obs.counts()
    for tag, inner_s in (("a", 0.02), ("b", 0.04)):
        outer, inner = f"span.{tag}.outer", f"span.{tag}.inner"
        assert got[f"{outer}.calls"] == got[f"{inner}.calls"] == 1
        assert got[f"{inner}.self_ns"] == got[f"{inner}.ns"] >= inner_s * 1e9
        assert got[f"{outer}.self_ns"] == got[f"{outer}.ns"] - got[
            f"{inner}.ns"]
        assert got[f"{outer}.self_ns"] >= 0.01 * 1e9


def test_span_totals_lose_no_update_across_threads(tracing):
    """16 threads, 200 nested pairs each, a short switch interval: every
    call is counted, and self time sums to total less children."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with obs.span("stress.outer"):
                    with obs.span("stress.inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = obs.counts()
    assert got["span.stress.outer.calls"] == got[
        "span.stress.inner.calls"] == 3200
    assert got["span.stress.outer.self_ns"] == got[
        "span.stress.outer.ns"] - got["span.stress.inner.ns"]


def test_counts_keeps_every_name_and_adds_the_new_ones():
    counts = ops.counts()
    assert OLD_NAMES <= set(counts)
    spans = {f"span.{s}.{part}" for s in SPANS
             for part in ("calls", "ns", "self_ns")}
    assert set(NEW_COUNTERS) | spans <= set(counts)
    assert {n for n in counts if n.endswith("_plain")} == {
        f"{n}_plain" for n in KERNELS}
    assert all(isinstance(v, int) for v in counts.values())
    ops.reset_counts()
    assert all(v == 0 for v in ops.counts().values())


def test_a_span_is_a_host_op_in_a_profile_not_a_user_annotation():
    """Under a profiler a span records with no enable(), and lands in the
    trace as a plain CPU operation; record_function's range is a user
    annotation (what the profiler mirrors on a device's timeline)."""
    ops.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("obs.test_span"):
            torch.ones(8).sum()
        with record_function("obs.test_annotation"):
            torch.ones(8).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    ours, theirs = events["obs.test_span"], events["obs.test_annotation"]
    assert ours.device_type() == DeviceType.CPU
    assert not ours.is_user_annotation()
    assert theirs.is_user_annotation()
    assert obs.counts()["span.obs.test_span.calls"] == 1
    with obs.span("obs.test_span"):
        pass
    assert obs.counts()["span.obs.test_span.calls"] == 1    # off again
    ops.reset_counts()


@pytest.mark.parametrize("a,c,reads,cg_steps,n_iter", [
    # 1-D, H = 1, c = 2: the first CG step meets the trust region's edge
    # (||s|| = delta = 2): 1 + [1 + (1 + 2) + 4] + 1 + 2
    ([1.0], [2.0], 12, 1, 2),
    # H = diag(2, 4), c = (2, 4): two CG steps inside the region, then the
    # residual test stops: 1 + [1 + (1 + 2 + 1 + 2 + 1) + 4] + 1 + 2
    ([2.0, 4.0], [2.0, 4.0], 16, 2, 2),
])
def test_tron_host_reads_counted_by_hand(tracing, a, c, reads, cg_steps,
                                         n_iter):
    """f(w) = ½ wᵀ diag(a) w − cᵀ w from w = 0: one read before the loop,
    the first iteration's norm, CG's tests, its four scalars, the second
    iteration's norm (which stops), two at the end."""
    at, ct = torch.tensor(a), torch.tensor(c)
    res = tron_minimize(lambda w: 0.5 * (w * at * w).sum() - (ct * w).sum(),
                        torch.zeros(len(a)))
    counts = ops.counts()
    assert res.converged and res.n_iter == n_iter
    torch.testing.assert_close(res.params, ct / at)
    assert counts["tron.host_reads"] == counts["span.tron.read.calls"] \
        == reads
    assert counts["tron.cg_steps"] == counts["span.tron.cg_step.calls"] \
        == cg_steps
    assert counts["span.tron.iter.calls"] == n_iter
    assert counts["span.tron.minimize.calls"] == 1
    assert not hasattr(res, "trace")


def test_plan_cache_counts_hits_and_builds():
    cache = bl._DwPlanCache(2)
    codes = torch.zeros((4, 3), dtype=torch.int32)
    plans = []

    def build(c, v):
        plans.append(object())
        return plans[-1]

    first = cache.get(codes, 8, build)
    assert (cache.builds.value, cache.hits.value) == (1, 0)
    assert cache.get(codes, 8, build) is first
    assert cache.get(codes, 8, build) is first
    assert (cache.builds.value, cache.hits.value) == (1, 2)
    codes.add_(1)                                  # an in-place write
    assert cache.get(codes, 8, build) is not first
    cache.get(codes, 16, build)                    # another V
    assert (cache.builds.value, cache.hits.value) == (3, 2)
    assert bl.bbit_linear_bwd_dw.plan_hits is bl._DW_PLANS.hits
    assert ops.PLAN_HITS is bl._DW_PLANS.hits
    ops.reset_counts()
    bl._DW_PLANS.hits.add()
    assert ops.counts()["bbit_linear_bwd_dw_plan_hits"] == 1
    ops.reset_counts()


@pytest.mark.cuda
def test_no_program_span_is_mirrored_on_the_device():
    """Under a profiler with CUDA activity, a B2 encode and a small TRON
    fit on the card (B7/B8) trace every program span as a host operation
    and none on the device's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 1 << 30, size=(64, 256))
                           .astype(np.int32)).to(dev)
    nnz = torch.full((64,), 256, dtype=torch.int32, device=dev)
    scheme = make_scheme("oph", 64, 1)
    scheme.encode_packed(ids, nnz, 8)                    # build, warm up
    codes, y = _problem(4)
    codes_t, y_t = torch.from_numpy(codes).to(dev), torch.from_numpy(y)
    cfg = BBitLinearConfig(k=16, b=4)
    ops.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scheme.encode_packed(ids, nnz, 8)
        fit = train_bbit_liblinear(codes_t[:200], y_t[:200], codes_t[200:],
                                   y_t[200:], cfg, max_iter=5, device=dev)
        torch.cuda.synchronize(dev)
    counts = ops.counts()
    ops.reset_counts()
    assert counts["oph_pack"] == 1 and counts["bbit_linear_bwd_dw"] >= 1
    host, device = set(), set()
    for e in prof.profiler.kineto_results.events():
        (device if e.device_type() == DeviceType.CUDA else host).add(e.name())
    assert set(SPANS) <= host
    assert not set(SPANS) & device
    assert counts["span.tron.iter.calls"] == fit.n_iter
    # the training labels came from the host (int32), the codes were on
    # the card; the test labels go to the accuracy as they are
    assert counts["trainer.h2d_bytes"] == 200 * 4
    assert counts["trainer.d2h_bytes"] > 0
