"""Port vs reference: the pieces of multi-process data-parallel training
(ROADMAP A5) that run in one process.

  * pure functions equal to the reference's: the int8 moment quantizer
    (``quantize`` / ``dequantize`` / ``maybe_quantize``) and the gradient
    quantizer (``_blockwise_quantize`` / ``_blockwise_dequantize``, the
    sign+scale path) bit for bit; ``physical_data_world``,
    ``process_fold``, ``process_slot_range`` and
    ``BackoffPolicy.for_rank`` over grids; heartbeat records read across
    packages both ways; ``group_batch_stream``'s every event byte for
    byte at worlds 2 and 3 with uneven tails and ``oph_zero`` masks;
  * AdamW with bfloat16 and int8 moments: 20 steps allclose (1e-4, 1e-5)
    to the reference, the moments' bytes equal; their checkpoints read
    across packages;
  * the dp step against the reference's dp step on
    tests/test_dp_streaming.py's ragged batch, exact and with
    ``compress`` 8 and 1: params, loss and hits at rtol 1e-6 / atol 1e-6,
    one Polyak step; two local devices give the fold's bits;
  * the collectives and their record (dtype kept, one all-reduce a
    dtype, the reference's dict shape);
  * coordinated checkpoints written by one package and restored by the
    other (each rank's payload written in one process, rank 1 first),
    torn payloads quarantined, the barrier's timeout; fault plans
    shipped as specs, their firing counts persisted, rank-scoped events.

The reference's dp step runs behind a test-side shim of ``shard_map``
(jax 0.9 took ``check_rep`` away; see ``reference_dp``); nothing of
``src/repro`` changes.  Everything runs on the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.train.data_parallel as j_data_parallel
from repro.ckpt import checkpoint as jckpt
from repro.ckpt import coordinated as jcoord
from repro.ckpt import elastic as jelastic
from repro.core.bbit import pack_codes
from repro.distributed import grad_compression as jgc
from repro.distributed import runtime as jruntime
from repro.ft.retry import BackoffPolicy as JBackoffPolicy
from repro.launch.mesh import make_data_mesh as j_make_data_mesh
from repro.models.linear import (BBitLinearConfig as JCfg,
                                 bbit_logits_packed as j_logits_packed,
                                 init_bbit_linear as j_init)
from repro.optim import optimizers as jopt
from repro.optim import quantized_state as jqs
from repro.data import hashed_dataset as jhd
from repro.data import prefetch as jprefetch
from repro.distributed.collectives import collective_bytes_from_hlo
from repro.train.losses import sum_loss_with_hits_fn as j_sum_loss
from repro.train.steps import init_averaged_state as j_init_averaged

from repro_torch import tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import coordinated, elastic
from repro_torch.data import hashed_dataset as thd
from repro_torch.data import prefetch as tprefetch
from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
from repro_torch.distributed import collectives
from repro_torch.distributed import grad_compression as tgc
from repro_torch.distributed import runtime
from repro_torch.ft import faults
from repro_torch.ft.retry import BackoffPolicy
from repro_torch.launch.mesh import make_data_mesh, make_replica_mesh
from repro_torch.models.linear import (BBitLinearConfig, bbit_logits_packed,
                                       params_from_jax)
from repro_torch.optim import optimizers as topt
from repro_torch.optim import quantized_state as tqs
from repro_torch.train.data_parallel import (build_dp_averaged_train_step,
                                             device_put_sharded,
                                             init_dp_error_state)
from repro_torch.train.losses import sum_loss_with_hits_fn
from repro_torch.train.steps import init_averaged_state


@pytest.fixture
def reference_dp(monkeypatch):
    """The reference's dp step on jax 0.9: ``shard_map`` without
    ``check_rep``, its replication check off (the packed logits'
    custom_vjp has no replication rule)."""
    _sm = jax.shard_map

    def shim(f, **kw):
        kw.pop("check_rep", None)
        return _sm(f, check_vma=False, **kw)
    monkeypatch.setattr(j_data_parallel, "shard_map", shim)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


# ------------------------------------------------ quantized moments ----
def _moment_values(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-6, 2, size=shape)
         ).astype(np.float32)
    if x.ndim >= 2:
        x[0] = 0.0                      # an all-zero row: scale 1
    return x


@pytest.mark.parametrize("shape", [(8,), (4, 256), (3, 5, 128), ()])
def test_quantize_matches_reference_bitwise(shape):
    x = _moment_values(shape, 1)
    want = jqs.quantize(jnp.asarray(x))
    got = tqs.quantize(torch.tensor(x))
    assert _bits_equal(got.q.numpy(), want.q)
    assert _bits_equal(got.scale.numpy(), want.scale)
    assert got.shape == tuple(want.shape) and got.dtype == torch.int8
    assert _bits_equal(tqs.dequantize(got).numpy(), jqs.dequantize(want))
    for dtype in ("float32", "bfloat16"):
        w = jqs.maybe_quantize(jnp.asarray(x), dtype)
        g = tqs.maybe_quantize(torch.tensor(x), dtype)
        assert _bits_equal(g.to(torch.float32).numpy(),
                           np.asarray(w, np.float32))
        assert _bits_equal(tqs.maybe_dequantize(g).numpy(),
                           jqs.maybe_dequantize(w))
    q8 = tqs.maybe_quantize(torch.tensor(x), "int8")
    assert isinstance(q8, tqs.QuantizedArray)
    assert _bits_equal(tqs.maybe_dequantize(q8).numpy(),
                       jqs.maybe_dequantize(jqs.maybe_quantize(
                           jnp.asarray(x), "int8")))


def _adam_pair(md, thr, wd):
    j = jopt.adamw(1e-2, jopt.AdamWConfig(
        moment_dtype=md, weight_decay=wd, chunked_update_threshold=thr))
    t = topt.adamw(1e-2, topt.AdamWConfig(
        moment_dtype=md, weight_decay=wd, chunked_update_threshold=thr))
    return j, t


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("md", ["bfloat16", "int8"])
@pytest.mark.parametrize("chunked", [False, True])
def test_adamw_narrow_moments_match_reference(md, chunked):
    """20 steps: params allclose (1e-4, 1e-5); the moments' bytes equal
    where each step's float32 inputs are (the whole-leaf update; the
    chunked one rounds the reference's fused loop differently, so there
    the moments are allclose)."""
    j_o, t_o = _adam_pair(md, 8 if chunked else 1 << 28, 0.01)
    rng = np.random.default_rng(4)
    p0 = {"table": rng.normal(size=(6, 16, 1)).astype(np.float32),
          "bias": rng.normal(size=(1,)).astype(np.float32)}
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    js = j_o.init(jp)
    tp = {n: torch.tensor(v) for n, v in p0.items()}
    ts = t_o.init(tp)
    for i in range(20):
        g = {n: rng.normal(size=v.shape).astype(np.float32)
             for n, v in p0.items()}
        jp, js = j_o.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                            jp, jnp.asarray(i, jnp.int32))
        tp, ts = t_o.update({n: torch.tensor(v) for n, v in g.items()}, ts,
                            tp, torch.tensor(i, dtype=torch.int32))
    for n in p0:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-4, atol=1e-5)
    want = [np.asarray(x) for x in jax.tree.leaves(js)]
    got = [_host(x) for x in tree.leaves(ts)]
    assert len(got) == len(want) == (8 if md == "int8" else 4)
    for g_, w_ in zip(got, want):
        if chunked:
            np.testing.assert_allclose(g_.astype(np.float32),
                                       w_.astype(np.float32),
                                       rtol=1e-2, atol=1e-6)
        else:
            assert _bits_equal(g_.astype(w_.dtype) if md == "bfloat16"
                               else g_, w_) or np.array_equal(
                g_.astype(np.float32), w_.astype(np.float32))
    if md == "int8":
        assert ts["m"]["table"].q.dtype == torch.int8
        assert tuple(ts["m"]["table"].scale.shape) == (6, 16, 1)


def test_int8_moment_checkpoints_read_across_packages(tmp_path):
    """An AdamW state with int8 moments saved by either package restores
    in the other with equal arrays (``QuantizedArray`` flattens to (q,
    scale) in both)."""
    j_o, t_o = _adam_pair("int8", 1 << 28, 0.0)
    p0 = {"table": np.linspace(-1, 1, 32, dtype=np.float32).reshape(2, 16, 1),
          "bias": np.ones((1,), np.float32)}
    tp = {n: torch.tensor(v) for n, v in p0.items()}
    ts = t_o.init(tp)
    g = {n: torch.full_like(v, 0.5) for n, v in tp.items()}
    tp, ts = t_o.update(g, ts, tp, torch.tensor(0, dtype=torch.int32))
    ckpt.save(str(tmp_path / "port"), 1, {"opt": ts})
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jtemplate = {"opt": j_o.init(jp)}
    restored, step = jckpt.restore(str(tmp_path / "port"), jtemplate)
    assert step == 1
    for a, b in zip(jax.tree.leaves(restored), tree.leaves({"opt": ts})):
        assert _bits_equal(a, b.numpy())
    jckpt.save(str(tmp_path / "ref"), 2, restored)
    back, _ = ckpt.restore(str(tmp_path / "ref"), {"opt": t_o.init(tp)})
    for a, b in zip(tree.leaves(back), tree.leaves({"opt": ts})):
        assert _bits_equal(a.numpy(), b.numpy())
    assert isinstance(back["opt"]["m"]["table"], tqs.QuantizedArray)


# ------------------------------------------------- gradient quantizer --
@pytest.mark.parametrize("shape,block", [((1000,), 256), ((3, 300), 256),
                                         ((16, 16, 1), 64), ((5,), 256)])
def test_blockwise_quantizer_matches_reference_bitwise(shape, block):
    rng = np.random.default_rng(7)
    g = rng.normal(size=shape).astype(np.float32)
    g.reshape(-1)[:block] = 0.0         # an all-zero block: scale 1
    jq, js = jgc._blockwise_quantize(jnp.asarray(g), block)
    tq, ts = tgc._blockwise_quantize(torch.tensor(g), block)
    assert _bits_equal(tq.numpy(), jq) and _bits_equal(ts.numpy(), js)
    assert _bits_equal(
        tgc._blockwise_dequantize(tq, ts, shape, block).numpy(),
        jgc._blockwise_dequantize(jq, js, shape, block))


def _reference_compressed(g, e, bits):
    """The reference's compressed all-reduce on a one-device mesh."""
    from jax.sharding import PartitionSpec as P
    mesh = j_make_data_mesh(1)
    fn = jax.shard_map(
        lambda a, b: jgc.compressed_allreduce_mean(a, b, "data", bits=bits),
        mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
        check_vma=False)
    return fn(jnp.asarray(g), jnp.asarray(e))


@pytest.mark.parametrize("bits", [8, 1])
def test_compressed_allreduce_matches_reference_bitwise(bits):
    """One device's exchange: the int8 and the sign+scale paths give the
    reference's mean and residual bytes."""
    rng = np.random.default_rng(bits)
    g = rng.normal(size=(16, 16, 1)).astype(np.float32)
    e = (rng.normal(size=g.shape) * 1e-3).astype(np.float32)
    want_mean, want_err = _reference_compressed(g, e, bits)
    mean, err = tgc.compressed_allreduce_mean(
        torch.tensor(g)[None], torch.tensor(e)[None], bits=bits)
    assert _bits_equal(mean.numpy(), want_mean)
    assert _bits_equal(err[0].numpy(), want_err)
    with pytest.raises(ValueError, match="bits"):
        tgc.compressed_allreduce_mean(torch.tensor(g)[None],
                                      torch.tensor(e)[None], bits=4)


# ------------------------------------------------------- topology ----
def test_physical_world_and_process_fold_equal_the_reference():
    for logical in range(1, 9):
        for n in range(1, 9):
            assert (elastic.physical_data_world(logical, n)
                    == jelastic.physical_data_world(logical, n))
    for logical in range(1, 9):
        for procs in range(1, 5):
            for local in range(1, 5):
                for el in (True, False):
                    try:
                        want = jelastic.process_fold(logical, procs, local,
                                                     elastic=el)
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            elastic.process_fold(logical, procs, local,
                                                 elastic=el)
                        assert str(got.value) == str(e)
                        continue
                    assert elastic.process_fold(
                        logical, procs, local, elastic=el) == want
    with pytest.raises(ValueError, match="logical world"):
        elastic.physical_data_world(0, 1)


def test_process_slot_range_equals_the_reference():
    for logical in range(1, 13):
        for procs in range(1, 5):
            for rank in range(procs):
                try:
                    want = jruntime.process_slot_range(logical, procs, rank)
                except ValueError:
                    with pytest.raises(ValueError, match="evenly"):
                        runtime.process_slot_range(logical, procs, rank)
                    continue
                assert runtime.process_slot_range(logical, procs,
                                                  rank) == want


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_backoff_for_rank_equals_the_reference(seed):
    kw = dict(base_s=0.5, cap_s=10.0, jitter_frac=0.5, seed=seed)
    mine, ref = BackoffPolicy(**kw), JBackoffPolicy(**kw)
    for r in range(4):
        assert mine.for_rank(r).seed == ref.for_rank(r).seed
        assert [mine.for_rank(r).delay_s(a) for a in range(6)] == [
            ref.for_rank(r).delay_s(a) for a in range(6)]
    assert len({mine.for_rank(r).delay_s(2) for r in range(6)}) == 6


def test_heartbeats_read_across_packages(tmp_path):
    d = str(tmp_path)
    runtime.heartbeat(runtime.ProcessRuntime(procs=2, rank=0, run_dir=d),
                      step=7, shards_done=3)
    jruntime.heartbeat(jruntime.ProcessRuntime(procs=2, rank=1, run_dir=d),
                       step=7, shards_done=4, phase="ckpt")
    mine, ref = runtime.read_heartbeats(d), jruntime.read_heartbeats(d)
    assert mine == ref and set(mine) == {0, 1}
    assert set(mine[0]) == set(mine[1]) == {
        "rank", "procs", "phase", "step", "shards_done", "time", "pid"}
    assert mine[0]["shards_done"] == 3 and mine[1]["phase"] == "ckpt"
    assert runtime.read_heartbeats(str(tmp_path / "none")) == {}
    # no run_dir: nothing written
    runtime.heartbeat(runtime.ProcessRuntime(procs=2, rank=1))


def test_runtime_meshes_and_validation():
    with pytest.raises(ValueError, match="coordinator"):
        runtime.init_runtime(procs=2, rank=0, coordinator=None,
                             device="cpu")
    with pytest.raises(ValueError, match="rank"):
        runtime.init_runtime(procs=2, rank=5, coordinator="127.0.0.1:1",
                             device="cpu")
    rt = runtime.init_runtime(procs=1, rank=0, device="cpu")
    try:
        assert runtime.current_runtime() is rt and rt.group is None
        assert runtime.current_rank() == 0 and faults.current_rank() == 0
        assert not rt.is_multiprocess and rt.is_leader
    finally:
        runtime.shutdown_runtime()
    assert runtime.current_runtime() is None
    assert runtime.choose_backend(torch.device("cpu"), 2) == "gloo"
    assert runtime.process_devices("cpu", 3, 2) == [torch.device("cpu")] * 2
    mesh = runtime.mesh_over_processes(
        2, runtime.ProcessRuntime(procs=2, rank=1, local_devices=2),
        device="cpu")
    assert mesh.physical == 4 and mesh.local == 2 and mesh.group is None
    assert [r for r, _ in mesh.placement] == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="devices"):
        runtime.mesh_over_processes(
            2, runtime.ProcessRuntime(procs=2, local_devices=1), "cpu")
    assert make_data_mesh(3, device="cpu").physical == 3
    assert make_replica_mesh(2, device="cpu") == [torch.device("cpu")] * 2
    m = elastic.mesh_from_available_devices(device="cpu")
    assert m.physical == 1
    tree_ = {"a": torch.ones(2), "n": np.int64(3)}
    moved = elastic.reshard(tree_, elastic.replicate_spec_tree(tree_, m))
    assert moved["a"].device.type == "cpu" and moved["n"] == 3


# ---------------------------------------------------- group stream ----
@pytest.fixture(scope="module")
def zero_archives(tmp_path_factory):
    """tests/test_dp_streaming.py's corpus: 250 documents into 5
    oph_zero shards (uneven tails at batch 32), by each package."""
    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=2000, max_triples_per_doc=1000)
    rows, labels = generate_arrays(250, cfg)
    d = tmp_path_factory.mktemp("grp")
    ref, port = str(d / "ref"), str(d / "port")
    kw = dict(k=16, b=4, seed=1, n_shards=5, scheme="oph_zero", chunk=64)
    jhd.preprocess_and_save(ref, rows, labels, **kw)
    thd.preprocess_and_save(port, rows, labels, device="cpu", **kw)
    return ref, port


def _events(mod, root, world, slot_range, port: bool):
    counts = (thd if port else jhd).shard_row_counts(root)

    def transfer(*arrays):
        return (arrays, None) if port else arrays
    out = []
    for ev in mod.group_batch_stream(
            root, 32, seed=3, epochs=2, n_shards=5, counts=counts,
            world=world, shuffle=True, start_epoch=0, start_pos=0,
            has_empty=True, packed_width=8, mask_width=2,
            transfer=transfer, slot_range=slot_range):
        if isinstance(ev, mod.Boundary):
            out.append(("b", ev.next_epoch, ev.next_pos,
                        ev.shards_consumed))
        else:
            out.append(("s", ev.n_rows,
                        tuple(a.tobytes() for a in ev.args)))
    return out


@pytest.mark.parametrize("world,slot_range", [
    (2, None), (3, None), (2, (1, 2)), (3, (0, 1))])
def test_group_batch_stream_equals_the_reference(zero_archives, world,
                                                 slot_range):
    ref, port = zero_archives
    want = _events(jprefetch, ref, world, slot_range, port=False)
    got = _events(tprefetch, port, world, slot_range, port=True)
    assert got == want
    assert sum(e[0] == "b" for e in got) == 2 * -(-5 // world)


def test_group_batch_stream_refuses_off_group_resume(zero_archives):
    with pytest.raises(ValueError, match="multiple of the world"):
        next(tprefetch.group_batch_stream(
            zero_archives[1], 32, seed=0, epochs=1, n_shards=5,
            counts=[50] * 5, world=2, shuffle=False, start_epoch=0,
            start_pos=1, has_empty=True, packed_width=8, mask_width=2,
            transfer=lambda *a: (a, None)))
    with pytest.raises(ValueError, match="slot_range"):
        next(tprefetch.group_batch_stream(
            zero_archives[1], 32, seed=0, epochs=1, n_shards=5,
            counts=[50] * 5, world=2, shuffle=False, start_epoch=0,
            start_pos=0, has_empty=True, packed_width=8, mask_width=2,
            transfer=lambda *a: (a, None), slot_range=(1, 3)))


# ------------------------------------------------------- the dp step --
K_DP, B_DP, ROWS_DP, L2_DP = 16, 4, 6, 1e-3


def _ragged_batch():
    """tests/test_dp_streaming.py:71's batch: 2 slots of 6 rows, slot 1
    with 2 valid rows."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, size=(2, ROWS_DP, K_DP)).astype(np.uint16)
    packed = np.stack([pack_codes(c, B_DP) for c in codes])
    labels = rng.integers(0, 2, size=(2, ROWS_DP)).astype(np.int32)
    valid = np.ones((2, ROWS_DP), bool)
    valid[1, 2:] = False
    return packed, labels, valid


def _reference_dp_step(compress):
    jcfg = JCfg(k=K_DP, b=B_DP)
    mesh = j_make_data_mesh(1)
    opt = jopt.make_optimizer("sgd", 0.1)
    step = j_data_parallel.build_dp_averaged_train_step(
        j_sum_loss(lambda p, pk: j_logits_packed(p, pk, jcfg), "logistic"),
        opt, mesh, l2=L2_DP, donate=False, logical_world=2,
        compress=compress)
    params = j_init(jcfg, jax.random.key(0))
    astate = j_init_averaged(params, opt)
    packed, labels, valid = _ragged_batch()
    put = lambda x: j_data_parallel.device_put_sharded(x, mesh)  # noqa
    carry = astate if compress is None else (
        astate, j_data_parallel.init_dp_error_state(params, 1))
    carry, (loss, hits) = step(carry, np.float32(1.0), put(packed),
                               put(labels), put(valid))
    a2 = carry if compress is None else carry[0]
    return params, a2, float(loss), int(hits)


def _port_dp_step(params_np, compress, local):
    cfg = BBitLinearConfig(k=K_DP, b=B_DP)
    mesh = make_data_mesh(local, device="cpu")
    opt = topt.make_optimizer("sgd", 0.1)
    step = build_dp_averaged_train_step(
        sum_loss_with_hits_fn(lambda p, pk: bbit_logits_packed(p, pk, cfg),
                              "logistic"),
        opt, mesh, l2=L2_DP, logical_world=2, compress=compress)
    params = params_from_jax(params_np, device="cpu")
    astate = init_averaged_state(params, opt)
    packed, labels, valid = _ragged_batch()
    put = lambda x: device_put_sharded(x, mesh)  # noqa: E731
    carry = astate if compress is None else (
        astate, init_dp_error_state(params, mesh.local))
    carry, (loss, hits) = step(carry, np.float32(1.0), put(packed),
                               put(labels), put(valid))
    a2 = carry if compress is None else carry[0]
    return a2, float(loss), int(hits)


@pytest.mark.parametrize("compress", [None, {"bits": 8, "block": 256},
                                      {"bits": 1, "block": 256}])
def test_dp_step_matches_reference(compress, reference_dp):
    params, want, want_loss, want_hits = _reference_dp_step(compress)
    got, loss, hits = _port_dp_step(
        {n: np.asarray(v) for n, v in params.items()}, compress, local=1)
    for n in ("bias", "table"):
        np.testing.assert_allclose(got.state.params[n].numpy(),
                                   np.asarray(want.state.params[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(got.avg_params[n].numpy(),
                                   got.state.params[n].numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert abs(loss - want_loss) < 1e-6 and hits == want_hits
    assert float(got.avg_count) == float(want.avg_count) == 1.0
    assert int(got.state.step) == 1


def test_dp_step_two_local_devices_give_the_folds_bits():
    """Two slots on two local devices (the sum over devices, then ÷ 2,
    × 2/total) against one device folding both (÷ 1, × 1/total): the
    same bits, power-of-two rescalings of one sum."""
    jparams = j_init(JCfg(k=K_DP, b=B_DP), jax.random.key(1))
    params = {n: np.asarray(v) for n, v in jparams.items()}
    fold, fl, fh = _port_dp_step(params, None, local=1)
    two, tl, th = _port_dp_step(params, None, local=2)
    assert tree.leaves(fold) and all(
        torch.equal(a, b) for a, b in zip(tree.leaves(fold),
                                          tree.leaves(two)))
    assert (fl, fh) == (tl, th)


def test_dp_step_refuses_an_uneven_fold():
    with pytest.raises(ValueError, match="fold"):
        build_dp_averaged_train_step(
            lambda *a: None, topt.make_optimizer("sgd", 0.1),
            make_data_mesh(2, device="cpu"), logical_world=3)


# ------------------------------------------------------- collectives --
def test_psum_mean_keeps_dtypes_and_records_fused_calls():
    collectives.reset_collective_stats()
    tree_ = {"a": torch.arange(8, dtype=torch.bfloat16).reshape(2, 4),
             "b": torch.ones((2, 3)), "c": torch.full((5,), 3.0)}
    out = collectives.psum_mean(tree_)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32
    assert torch.equal(out["a"], tree_["a"]) and torch.equal(out["c"],
                                                             tree_["c"])
    half = collectives.psum_mean(tree_, count=2)
    assert torch.equal(half["c"], torch.full((5,), 1.5))
    assert torch.equal(collectives.psum({"x": torch.ones(3)})["x"],
                       torch.ones(3))
    stats = collectives.collective_stats()
    # one all-reduce a dtype a call: (bf16, f32) twice, then one f32
    assert [s["op"] for s in stats] == ["all-reduce"] * 5
    assert [s["bytes"] for s in stats[:2]] == [16, 44]
    assert {s["group_size"] for s in stats} == {1}
    gathered = collectives.all_gather_stacked(torch.ones(4, dtype=torch.int8))
    assert tuple(gathered.shape) == (1, 4)
    cb = collectives.collective_bytes()
    assert set(cb) == set(collective_bytes_from_hlo(""))
    assert cb["all-gather"] == 4 and cb["count"] == 6
    assert cb["total"] == sum(s["bytes"] for s in
                              collectives.collective_stats())
    collectives.reset_collective_stats()
    assert collectives.collective_bytes()["count"] == 0


# ------------------------------------------- coordinated checkpoints --
def _ckpt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"astate": {"table": rng.normal(size=(4, 16, 1)).astype(
        np.float32), "bias": rng.normal(size=(1,)).astype(np.float32)},
        "epoch": np.int64(1), "fingerprint": np.int64(123)}


def _torch_tree(t):
    return {"astate": {n: torch.tensor(v) for n, v in t["astate"].items()},
            "epoch": np.int64(0), "fingerprint": np.int64(0)}


def test_reference_coordinated_step_restores_in_the_port(tmp_path):
    root = str(tmp_path)
    t = _ckpt_tree(0)
    extra = {"schedule": {"dp": True, "logical_world": 2, "procs": 2}}
    assert jcoord.save_coordinated(root, 4, t, rank=1, procs=2) is None
    final = jcoord.save_coordinated(root, 4, t, rank=0, procs=2,
                                    extra_meta=extra)
    assert coordinated.is_coordinated_dir(final)
    got, step = ckpt.restore(root, _torch_tree(t))
    assert step == 4
    for a, b in zip(tree.leaves(got), tree.leaves(t)):
        assert _bits_equal(a.numpy() if isinstance(a, torch.Tensor) else a,
                           b)
    assert ckpt.load_meta(root, 4)["schedule"] == extra["schedule"]


def test_port_coordinated_step_restores_in_the_reference(tmp_path):
    root = str(tmp_path)
    t = _torch_tree(_ckpt_tree(1))
    t["epoch"], t["fingerprint"] = np.int64(2), np.int64(99)
    assert coordinated.save_coordinated(root, 8, t, rank=1,
                                        procs=2) is None
    final = coordinated.save_coordinated(root, 8, t, rank=0, procs=2)
    assert jcoord.is_coordinated_dir(final)
    arrays = jcoord.load_step_arrays(final, prefer_rank=1)
    want = [x.numpy() if isinstance(x, torch.Tensor) else x
            for x in tree.leaves(t)]
    assert len(arrays) == len(want)
    for i, w in enumerate(want):
        assert _bits_equal(arrays[f"leaf_{i:05d}"], w)
    jt = jax.tree.map(jnp.asarray, _ckpt_tree(5))
    restored, step = jckpt.restore(root, jt)
    assert step == 8 and int(restored["epoch"]) == 2
    meta = json.load(open(os.path.join(final, "meta.json")))
    assert meta["procs"] == 2 and set(meta["rank_crc32"]) == {"0", "1"}


def test_torn_rank_payload_is_quarantined_and_another_used(tmp_path):
    root = str(tmp_path)
    t = _torch_tree(_ckpt_tree(2))
    coordinated.save_coordinated(root, 4, t, rank=1, procs=2)
    final = coordinated.save_coordinated(root, 4, t, rank=0, procs=2)
    payload = os.path.join(final, "rank_00000", "ckpt.npz")
    size = os.path.getsize(payload)
    with open(payload, "r+b") as f:
        f.truncate(size // 2)
    got, step = ckpt.restore(root, _torch_tree(_ckpt_tree(9)))
    assert step == 4
    assert torch.equal(got["astate"]["table"], t["astate"]["table"])
    assert os.path.isdir(os.path.join(final, "rank_00000.quarantined"))
    assert not os.path.exists(os.path.join(final, "rank_00000"))
    # every payload torn: the step is corrupt, nothing valid is left
    payload = os.path.join(final, "rank_00001", "ckpt.npz")
    with open(payload, "r+b") as f:
        f.truncate(10)
    with pytest.raises(FileNotFoundError, match="no valid"):
        ckpt.restore(root, _torch_tree(_ckpt_tree(9)))


def test_coordinated_barrier_times_out_without_a_rank(tmp_path):
    with pytest.raises(RuntimeError, match="timed out"):
        coordinated.save_coordinated(str(tmp_path), 2,
                                     _torch_tree(_ckpt_tree(3)), rank=0,
                                     procs=2, barrier_timeout_s=0.1)
    # nothing was committed: only the stage is left
    assert ckpt.latest_step(str(tmp_path)) is None
    assert os.path.isdir(str(tmp_path / ".stage-s2"))


def test_torn_rank_write_fault_and_coordinated_ring(tmp_path):
    root = str(tmp_path)
    t = _torch_tree(_ckpt_tree(4))
    plan = faults.FaultPlan([faults.FaultEvent(site="ckpt_write", at_save=6,
                                               rank=0, times=1)])
    def as_rank_1(step):
        faults.set_rank(1)               # rank 0's event: not rank 1's
        try:
            coordinated.save_coordinated(root, step, t, rank=1, procs=2,
                                         keep_last=2)
        finally:
            faults.set_rank(0)
    with faults.arm(plan):
        for step in (2, 4):
            as_rank_1(step)
            coordinated.save_coordinated(root, step, t, rank=0, procs=2,
                                         keep_last=2)
        as_rank_1(6)
        with pytest.raises(faults.InjectedCrash, match="rank-0"):
            coordinated.save_coordinated(root, 6, t, rank=0, procs=2)
    assert plan.events[0].fired == 1
    assert json.load(open(os.path.join(root, "manifest.json")))[
        "steps"] == [2, 4]


# ------------------------------------------------------- fault plans --
def test_fault_plans_ship_as_specs_and_persist_firings(tmp_path):
    from repro.ft.faults import FaultEvent as JEvent, FaultPlan as JPlan
    events = [dict(site="proc_kill", step=5, rank=1, times=1),
              dict(site="manifest_write", at_save=4, rank=0),
              dict(site="slow_step", step=2, delay_s=0.0, times=None)]
    plan = faults.FaultPlan([faults.FaultEvent(**e) for e in events],
                            seed=7)
    jplan = JPlan([JEvent(**e) for e in events], seed=7)
    assert plan.to_spec() == jplan.to_spec()
    state = str(tmp_path / "fired.json")
    shipped = faults.FaultPlan.from_spec(plan.to_spec(), state)
    assert [e.fired for e in shipped.events] == [0, 0, 0]
    with faults.arm(shipped):
        faults.on_train_step(2)          # slow_step, rank-free: fires
        faults.set_rank(1)
        try:
            faults.on_manifest_write(4)  # rank 0's event: not here
        finally:
            faults.set_rank(0)
    assert json.load(open(state)) == {"0": 0, "1": 0, "2": 1}
    again = faults.FaultPlan.from_spec(plan.to_spec(), state)
    assert [e.fired for e in again.events] == [0, 0, 1]
    j_again = JPlan.from_spec(jplan.to_spec(), state)
    assert [e.fired for e in j_again.events] == [0, 0, 1]
