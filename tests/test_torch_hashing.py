"""Port vs reference: hash parameters, fmix32, b-bit packing, OPH
densify, row padding, the synthetic corpus and the host encode — all
byte for byte — plus the port's import isolation from JAX."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bbit as jbbit
from repro.core import oph as joph
from repro.core import universal_hash as juh
from repro.core.schemes import make_scheme as j_make_scheme
from repro.data import packing as jpacking
from repro.data import synth_rcv1 as jsynth

from repro_torch.core import bbit as tbbit
from repro_torch.core import oph as toph
from repro_torch.core import universal_hash as tuh
from repro_torch.core.schemes import make_scheme as t_make_scheme
from repro_torch.data import packing as tpacking
from repro_torch.data import synth_rcv1 as tsynth

EDGE_WORDS = np.array([0, 1, 2, 0x7FFFFFFF, 1 << 31, (1 << 31) + 1,
                       0xFFFFFFFE, 0xFFFFFFFF, 0x85EBCA6B, 0xC2B2AE35,
                       0x9E3779B1], dtype=np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 + 5])
@pytest.mark.parametrize("k", [1, 37, 256])
def test_multiply_shift_params_match_reference(seed, k):
    ref = juh.MultiplyShiftHash.make(k, seed)
    got = tuh.MultiplyShiftHash.make(k, seed)
    assert got.a == ref.a and got.b == ref.b
    a, b = got.params()
    assert a.dtype == torch.int32
    assert np.array_equal(a.numpy().view(np.uint32),
                          np.asarray(ref.params()[0]))
    assert np.array_equal(b.numpy().view(np.uint32),
                          np.asarray(ref.params()[1]))


@pytest.mark.parametrize("seed", [0, 3, 99, 2**33 + 1])
@pytest.mark.parametrize("k", [2, 64, 256])
def test_oph_params_match_reference(seed, k):
    ref = joph.OPHHash.make(k, seed)
    got = toph.OPHHash.make(k, seed)
    assert (got.a, got.b, got.k, got.shift) == (ref.a, ref.b, ref.k,
                                                ref.shift)
    a, b = got.params()
    assert int(a.numpy().view(np.uint32)[0]) == ref.a
    assert int(b.numpy().view(np.uint32)[0]) == ref.b


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 1])
@pytest.mark.parametrize("k", [1, 64, 500])
def test_mod_prime_family_matches_reference(seed, k):
    ref = juh.ModPrimeHash.make(k, seed)
    got = tuh.ModPrimeHash.make(k, seed)
    assert got.k == ref.k == k
    assert np.array_equal(got.c1, ref.c1) and np.array_equal(got.c2, ref.c2)
    rng = np.random.default_rng(seed % 1000)
    t = np.concatenate([np.array([0, 1, (1 << 30) - 1, 1 << 30,
                                  (1 << 31) - 1, (1 << 40) + 3]),
                        rng.integers(0, 1 << 31, size=50)])
    h = got(t.reshape(8, 7))
    assert h.dtype == np.uint64 and h.shape == (8, 7, k)
    assert np.array_equal(h, ref(t.reshape(8, 7)))
    assert np.all(h < juh.MERSENNE61)
    # the exact residue, in Python integers
    p = (1 << 61) - 1
    assert int(h[0, 1, 0]) == (int(ref.c1[0]) + int(ref.c2[0]) * int(t[1])) % p


def test_mersenne61_helpers_match_reference():
    rng = np.random.default_rng(1)
    a = rng.integers(0, (1 << 61) - 1, size=200, dtype=np.uint64)
    b = rng.integers(0, 1 << 31, size=200, dtype=np.uint64)
    c = rng.integers(0, (1 << 61) - 1, size=200, dtype=np.uint64)
    assert np.array_equal(tuh._mulmod_mersenne61(a, b),
                          juh._mulmod_mersenne61(a, b))
    assert np.array_equal(tuh._addmod_mersenne61(a, c),
                          juh._addmod_mersenne61(a, c))
    assert np.array_equal(tuh._reduce_mersenne61(a * np.uint64(3)),
                          juh._reduce_mersenne61(a * np.uint64(3)))
    p = (1 << 61) - 1
    assert [int(x) for x in tuh._mulmod_mersenne61(a, b)] == \
        [int(x) * int(y) % p for x, y in zip(a, b)]


@pytest.mark.parametrize("k,dim,seed", [(1, 10, 0), (20, 300, 5),
                                        (64, 1000, 2**31 + 5)])
def test_permutation_family_matches_reference(k, dim, seed):
    ref = juh.PermutationHash.make(k, dim, seed)
    got = tuh.PermutationHash.make(k, dim, seed)
    assert (got.k, got.dim) == (ref.k, ref.dim) == (k, dim)
    assert np.array_equal(got.perms, ref.perms)
    t = np.random.default_rng(0).integers(0, dim, size=(4, 9))
    assert np.array_equal(got(t), ref(t))


def test_make_hash_family_matches_reference():
    for kind, kw in (("mod_prime", {}), ("multiply_shift", {}),
                     ("permutation", {"dim": 50})):
        got = tuh.make_hash_family(kind, 12, 3, **kw)
        ref = juh.make_hash_family(kind, 12, 3, **kw)
        assert type(got).__name__ == type(ref).__name__
        assert got.k == ref.k == 12
    assert tuh.make_hash_family("multiply_shift", 12, 3).a == \
        juh.make_hash_family("multiply_shift", 12, 3).a
    for kind, kw, match in (("permutation", {}, "needs dim > 0"),
                            ("permutation", {"dim": 0}, "needs dim > 0"),
                            ("tabulation", {}, "unknown hash family")):
        for mod in (tuh, juh):
            with pytest.raises(ValueError, match=match):
                mod.make_hash_family(kind, 4, 0, **kw)


def test_oph_rejects_non_power_of_two_k():
    for k in (0, 1, 3, 100):
        with pytest.raises(ValueError):
            toph.OPHHash.make(k, 0)


def _odd_multipliers():
    return np.asarray(juh.MultiplyShiftHash.make(64, 5).a, dtype=np.uint32)


def test_fmix32_matches_numpy_on_edge_words():
    rng = np.random.default_rng(0)
    words = np.concatenate([EDGE_WORDS, _odd_multipliers(),
                            rng.integers(0, 1 << 32, size=4096,
                                         dtype=np.uint64).astype(np.uint32)])
    got = tuh.fmix32(torch.from_numpy(words.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32),
                          juh._fmix32_numpy(words))
    assert np.array_equal(got.numpy().astype(np.uint32),
                          np.asarray(juh._fmix32(jnp.asarray(words))))


def test_mul32_wraps_like_uint32():
    a = _odd_multipliers()
    x = np.concatenate([EDGE_WORDS, a])
    xs, cs = np.meshgrid(x, np.concatenate([EDGE_WORDS, a]))
    want = (xs.astype(np.uint32) * cs.astype(np.uint32)).astype(np.uint32)
    got = tuh.mul32(torch.from_numpy(xs.astype(np.int64)),
                    torch.from_numpy(cs.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_word_conversion_round_trips():
    t = tuh.words_to_int32(EDGE_WORDS)
    assert t.dtype == torch.int32
    assert np.array_equal(tuh.int32_to_words(t).numpy(),
                          EDGE_WORDS.astype(np.int64))


@pytest.mark.parametrize("b", [1, 2, 4, 6, 8, 16])
def test_pack_unpack_match_reference(b):
    rng = np.random.default_rng(b)
    codes = rng.integers(0, 1 << b, size=(7, 37)).astype(np.uint16)
    want = jbbit.pack_codes(codes, b)
    assert np.array_equal(tbbit.pack_codes(codes, b), want)
    got = tbbit.pack_codes_torch(torch.from_numpy(codes.astype(np.int64)), b)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          np.asarray(jbbit.pack_codes_jnp(jnp.asarray(codes),
                                                          b)))
    assert tbbit.packed_width(37, b) == jbbit.packed_width(37, b)
    assert np.array_equal(tbbit.unpack_codes(want, 37, b),
                          jbbit.unpack_codes(want, 37, b))
    assert np.array_equal(
        tbbit.unpack_codes_torch(torch.from_numpy(want), 37, b).numpy(),
        codes.astype(np.int64))


@pytest.mark.parametrize("k", [1, 8, 43])
def test_mask_pack_unpack_match_packbits(k):
    rng = np.random.default_rng(k)
    mask = rng.random((6, k)) < 0.3
    got = tbbit.pack_mask_torch(torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), np.packbits(mask, axis=1))
    assert tbbit.packed_mask_width(k) == jbbit.packed_mask_width(k)
    assert np.array_equal(tbbit.unpack_mask_torch(got, k).numpy(), mask)


@pytest.mark.parametrize("k", [2, 8, 64])
def test_densify_rotation_matches_reference(k):
    rng = np.random.default_rng(k)
    vals = rng.integers(0, 1 << 32, size=(9, k), dtype=np.uint64).astype(
        np.uint32)
    empty = rng.random((9, k)) < 0.7
    empty[0] = True           # all-empty row
    empty[1] = False          # full row
    empty[2] = True
    empty[2, -1] = False      # one survivor at the wrap point
    vals[empty] = 0xFFFFFFFF
    want, want_e = joph.densify_rotation_numpy(vals, empty)
    got, got_e = toph.densify_rotation(torch.from_numpy(vals.astype(np.int64)),
                                       torch.from_numpy(empty))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert np.array_equal(got_e.numpy(), want_e)
    tn, te = toph.densify_rotation_numpy(vals, empty)
    assert np.array_equal(tn, want) and np.array_equal(te, want_e)


def test_pad_rows_and_bucket_width_match_reference():
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 1 << 40, size=int(s)) for s in (0, 3, 17, 200)]
    rows.append(np.array([(1 << 31) + 5, (1 << 33) - 1, 7]))
    for kw in ({}, {"pad_to_multiple": 1}, {"max_nnz": 10},
               {"bucket": True, "pad_to_multiple": 8}):
        gi, gn = tpacking.pad_rows(rows, **kw)
        wi, wn = jpacking.pad_rows(rows, **kw)
        assert np.array_equal(gi, wi) and np.array_equal(gn, wn)
    for m in (0, 1, 100, 129, 5000):
        assert tpacking.bucket_width(m) == jpacking.bucket_width(m)


def test_synth_rcv1_matches_reference():
    kw = dict(seed=3, topic_tokens=150, background_frac=0.35,
              max_pairs_per_doc=3000, max_triples_per_doc=1500)
    g_rows, g_lab = tsynth.generate_arrays(6, tsynth.SynthRcv1Config(**kw))
    w_rows, w_lab = jsynth.generate_arrays(6, jsynth.SynthRcv1Config(**kw))
    assert np.array_equal(g_lab, w_lab)
    for g, w in zip(g_rows, w_rows):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
@pytest.mark.parametrize("b", [1, 4, 6, 8])
def test_encode_packed_numpy_matches_reference(scheme, b):
    rng = np.random.default_rng(b)
    idx = rng.integers(0, 1 << 31, size=(7, 90)).astype(np.int32)
    nnz = np.array([0 if scheme == "oph_zero" else 1, 3, 90, 40, 12, 64, 7],
                   np.int32)
    got_p, got_e = t_make_scheme(scheme, 64, 11).encode_packed_numpy(
        idx, nnz, b)
    want_p, want_e = j_make_scheme(scheme, 64, 11).encode_packed_numpy(
        idx, nnz, b)
    assert np.array_equal(got_p, want_p)
    assert (got_e is None) == (want_e is None)
    if want_e is not None:
        assert np.array_equal(got_e, want_e)


def test_port_imports_no_jax_and_no_reference(repo_src):
    """A fresh interpreter imports the port (its HTTP tier and launchers
    too), scores, hashes and stream-trains over a two-shard archive on
    the CPU without loading jax or any module of the reference
    package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from repro_torch.models.linear import BBitLinearConfig, init_bbit_linear
        from repro_torch.serving import HashedClassifierEngine
        from repro_torch.kernels import ops
        from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
        from repro_torch.data.hashed_dataset import (preprocess_rows,
                                                     preprocess_rows_packed)
        from repro_torch.retrieval import BandedLSHIndex
        from repro_torch.train.linear_trainer import train_bbit_liblinear
        cfg = BBitLinearConfig(k=16, b=8)
        params = init_bbit_linear(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        rows, _ = generate_arrays(3, SynthRcv1Config(seed=1))
        for scheme in ("minwise", "oph", "oph_zero"):
            with HashedClassifierEngine(params, cfg, scheme=scheme,
                                        device="cpu",
                                        nnz_buckets=(4096,)) as eng:
                assert np.isfinite(eng.score_docs(rows)).all()
        served = ops.counts()["oph_pack_plain"]
        assert preprocess_rows(rows, k=16, b=16, device="cpu").shape == (3, 16)
        packed, _ = preprocess_rows_packed(rows, k=16, b=8, scheme="oph",
                                           device="cpu")
        index = BandedLSHIndex(k=16, b=8, rows_per_band=4, device="cpu")
        index.insert([0, 1, 2], packed)
        assert index.query(packed[1])[0][0] == 1
        import tempfile
        import repro_torch.ckpt.checkpoint, repro_torch.ft.faults
        import repro_torch.data.prefetch, repro_torch.launch.train
        import repro_torch.serving.dedup, repro_torch.serving.admission
        import repro_torch.serving.server, repro_torch.serving.reload
        import repro_torch.launch.serve
        import repro_torch.distributed, repro_torch.train.data_parallel
        import repro_torch.train.worker, repro_torch.ckpt.coordinated
        import repro_torch.ckpt.elastic, repro_torch.launch.mesh
        import repro_torch.optim.quantized_state
        from repro_torch.data.hashed_dataset import preprocess_and_save
        from repro_torch.train.streaming import fit_streaming
        rows, labels = generate_arrays(40, SynthRcv1Config(seed=2))
        with tempfile.TemporaryDirectory() as root:
            preprocess_and_save(root, rows, labels, k=16, b=8,
                                scheme="oph", n_shards=2, device="cpu")
            res = fit_streaming(root, cfg, batch_size=8, device="cpu",
                                ckpt_dir=root + "/ckpt")
            dp = fit_streaming(root, cfg, batch_size=8, device="cpu",
                               data_parallel=2, elastic=True,
                               grad_compress=8)
        assert res.completed and res.n_steps == 6, res
        assert dp.completed and dp.topology_lineage[0]["logical"] == 2
        # the codes' leftovers, the loaders and I/O, fsck, the cost model
        # and calibration, the paper's config and --mode linear
        import repro_torch.core.estimators, repro_torch.core.expansion
        import repro_torch.core.random_projection, repro_torch.core.types
        import repro_torch.data.libsvm_io, repro_torch.data.loader
        import repro_torch.launch.fsck, repro_torch.launch.calibrate
        import repro_torch.configs.rcv1_bbit, repro_torch.ft.watchdog
        from repro_torch import perf
        from repro_torch.core.types import SparseBatch
        from repro_torch.core.random_projection import rp_project_batch
        from repro_torch.core.expansion import compact_index
        batch = SparseBatch.from_lists([[1, 5], [2]], dim=8, device="cpu")
        assert rp_project_batch(batch, k=4).shape == (2, 4)
        assert compact_index(torch.zeros((2, 4), dtype=torch.int32), 2,
                             8).shape == (2, 8)
        with tempfile.TemporaryDirectory() as root:
            table = perf.calibrate(k=16, encode_rows=(2,),
                                   encode_widths=(8,), logits_rows=(4,),
                                   max_batch=2, nnz_buckets=(8,), trials=1,
                                   budget_s=30, device="cpu")
            table.save(root + "/p.json")
            assert perf.maybe_load_profile(root + "/p.json")
            import argparse, contextlib, io
            from repro_torch.launch.train import run_linear
            with contextlib.redirect_stdout(io.StringIO()):
                run_linear(argparse.Namespace(
                    workdir=root, n_docs=24, k=8, b=12, steps=2,
                    batch_size=4, lr=1e-2, seed=0, ckpt_every=1,
                    fail_at=None, device="cpu"))
                assert repro_torch.launch.fsck.main([root + "/hashed"]) == 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("OK", served)
    """)
    env = dict(os.environ, PYTHONPATH=repo_src)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["OK", "2"]
