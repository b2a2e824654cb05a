"""The port's CUDA kernels against their plain torch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one; the
file imports nothing of JAX, so it runs on a machine that has only
torch:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Integer outputs (B1-B4, B10, B8's plan) must be equal, and B3, B4 and
B10 give the same bytes on two calls; B1 at the engine's row buckets and
lanes and at every launch layout it has; B10 at every load width (16 bytes,
4, 1) and on rows and a query that start on an odd address.  B5–B8 sum in another order than
torch, so they are held to allclose at 1e-5 and to run-to-run equality
(B6 and B8 bit-identical on two calls; B6 also within 1e-5 of each bin's
sum of absolute terms, at every layout, on rows that all share a code
and with V beyond 4,096).  B9 with values of ones must
equal its plain version byte for byte, in both of its designs (lanes and
slices) and with nnz of 0, M, more than M and below 0; with random values
allclose at 1e-5 and run-to-run equal; a row whose ids all hash to one
bucket within 1e-5 of its sum of absolute terms.

The serving tier on the card: the dedup cache's host-encode bytes equal
B1's and B2's at the engine's lanes and row buckets 1 and 64, a cache
hit equals a fresh score at both row buckets bit for bit, and
``fused=False`` launches B3/B4 and B7 (``oph_zero``: B4 and the masked
product's plain version, which has no kernel); ``launch/serve.py
--http --device cuda`` binds, answers and drains on SIGTERM.

The streaming path on the card: archives written by B2 equal the CPU's
byte for byte; ``fit_streaming`` (B5 forward, B6 dW, with and without the
``oph_zero`` mask) and ``train_bbit_sgd`` (B7, B8 with a plan a
minibatch) allclose to the CPU at 1e-4 / 1e-5 with the same steps;
prefetch depths 0-2 and a resume bit-identical; the pinned encode
pipeline (two chunks in flight) byte-equal to the CPU; B5 and B6 on a
padded shard slot of the dp step, and the dp fit (two slots folded onto
the card) allclose to the CPU's."""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.oph import OPHHash
from repro_torch.core.universal_hash import MultiplyShiftHash
from repro_torch.core.bbit import pack_codes
from repro_torch.kernels import (bbit_linear, fused_encode, hamming,
                                 minhash, ops, oph, vw_sketch)
from repro_torch.models.linear import BBitLinearConfig, init_bbit_linear
from repro_torch.serving import HashedClassifierEngine

pytestmark = pytest.mark.cuda

B_FUSED = (1, 2, 4, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _full_rows(n, m, seed, dev):
    """n rows of m ids, every id live (any n, 1 included)."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, 1 << 31, (n, m), dtype=torch.int32, generator=gen)
    return idx.to(dev), torch.full((n,), m, dtype=torch.int32, device=dev)


def _rows(n, m, seed, dev):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 31, size=(n, m)).astype(np.int32)
    nnz = rng.integers(1, m + 1, size=(n,)).astype(np.int32)
    nnz[0] = 0
    nnz[1] = min(3, m)
    nnz[2] = m
    return torch.from_numpy(idx).to(dev), torch.from_numpy(nnz).to(dev)


@pytest.mark.parametrize("bits", B_FUSED)
@pytest.mark.parametrize("k,m", [(256, 8192), (37, 100), (8, 3000)])
def test_minhash_pack_kernel_matches_plain(cuda, bits, k, m):
    idx, nnz = _rows(64, m, seed=bits + k, dev=cuda)
    a, b = MultiplyShiftHash.make(k, seed=bits).params(cuda)
    got = fused_encode.minhash_pack(idx, nnz, a, b, bits=bits)
    want = fused_encode.minhash_pack_plain(idx, nnz, a, b, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _minwise_rows(n, m, seed, dev, offset=0):
    """n rows of m ids for B1: with n >= 5, row 0 empty (nnz 0), row 1 a
    negative nnz, row 2 more than m, row 3 one id, row 4 the whole lane,
    the rest random; one row: m - 7 ids.  ``offset`` int32s before the
    first row, so that no row starts 16-byte aligned."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, m + 1, size=(n,)).astype(np.int32)
    if n >= 5:
        nnz[:5] = [0, -3, m + 5, 1, m]
    else:
        nnz[:] = m - 7
    buf = torch.from_numpy(rng.integers(0, 1 << 31, size=(n * m + offset,))
                           .astype(np.int32))
    return (buf.to(dev)[offset:].view(n, m),
            torch.from_numpy(nnz).to(dev))


@pytest.mark.parametrize("bits", B_FUSED)
@pytest.mark.parametrize("k", [8, 37, 256, 500, 1000])
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("m,offset", [(2048, 0), (8192, 0), (4099, 0),
                                      (2048, 1)])
def test_minhash_pack_kernel_at_the_serving_buckets(cuda, bits, k, n, m,
                                                    offset):
    """The engine's row buckets and lanes, k up to 1,000 (not a multiple
    of the 8 lanes a thread, and more lanes than a block), empty rows,
    a negative nnz and one above m, and rows that do not start 16-byte
    aligned (m=4099, or the ids one int32 past an aligned address: scalar
    loads); equal to the plain version byte for byte."""
    idx, nnz = _minwise_rows(n, m, seed=m + n + k + bits, dev=cuda,
                             offset=offset)
    a, b = MultiplyShiftHash.make(k, seed=bits).params(cuda)
    assert fused_encode.oph_pack_vec(m, idx.data_ptr()) == (
        m % 4 == 0 and offset == 0)
    got = fused_encode.minhash_pack(idx, nnz, a, b, bits=bits)
    want = fused_encode.minhash_pack_plain(idx, nnz, a, b, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("nnz", [0, -3, 1, 3, 4, 5, 2048, 2100])
def test_minhash_pack_kernel_one_row_edges(cuda, nnz):
    """One row whose nnz is 0, negative, less than a 4-id group, a few
    groups and a partial one, the lane, or above it."""
    idx, _ = _minwise_rows(1, 2048, seed=nnz + 7, dev=cuda)
    n_t = torch.tensor([nnz], dtype=torch.int32, device=cuda)
    a, b = MultiplyShiftHash.make(256, seed=5).params(cuda)
    for bits in B_FUSED:
        got = fused_encode.minhash_pack(idx, n_t, a, b, bits=bits)
        want = fused_encode.minhash_pack_plain(idx, n_t, a, b, bits=bits)
        torch.cuda.synchronize()
        assert torch.equal(got, want), bits


@pytest.mark.parametrize("bits", [1, 8])
@pytest.mark.parametrize("k,m,offset", [(256, 8192, 0), (37, 300, 1),
                                        (500, 4099, 0)])
def test_minhash_pack_kernel_every_layout(cuda, bits, k, m, offset):
    """Each hash lanes a thread, threads of them and warps a block, and
    load width that B1 can run at, equal to the plain version byte for
    byte."""
    idx, nnz = _minwise_rows(6, m, seed=k, dev=cuda, offset=offset)
    a, b = MultiplyShiftHash.make(k, seed=3).params(cuda)
    want = fused_encode.minhash_pack_plain(idx, nnz, a, b, bits=bits)
    vecs = {False, fused_encode.oph_pack_vec(m, idx.data_ptr())}
    for lpt in (1, 2, 4, 8):
        for lt in (1, 2, 4, 8, 16, 32):
            if lpt * lt * bits % 8:
                continue              # a block's codes are whole bytes
            for warps in (1, 4, 16):
                for vec in vecs:
                    got = fused_encode._minhash_pack_launch(
                        idx, nnz, a, b, bits, lpt, lt, warps, vec)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (lpt, lt, warps, vec)


@pytest.mark.parametrize("bits", B_FUSED)
@pytest.mark.parametrize("densify", [True, False])
@pytest.mark.parametrize("k,m", [(256, 8192), (8, 50), (16384, 2048)])
def test_oph_pack_kernel_matches_plain(cuda, bits, densify, k, m):
    idx, nnz = _rows(32, m, seed=bits + k, dev=cuda)
    a, b = OPHHash.make(k, seed=bits).params(cuda)
    got = fused_encode.oph_pack(idx, nnz, a, b, k=k, bits=bits,
                                densify=densify)
    want = fused_encode.oph_pack_plain(idx, nnz, a, b, k=k, bits=bits,
                                       densify=densify)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _serving_rows(n, m, k, seed, dev, offset=0):
    """n rows of m ids for B2: with n >= 4, row 0 all empty (nnz 0), row 1
    one id, row 2 k - 1 ids (fewer than the bins), row 3 the whole lane,
    the rest random; one row: m - 7 ids.  ``offset`` int32s before the
    first row, so that no row starts 16-byte aligned."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, m + 1, size=(n,)).astype(np.int32)
    if n >= 4:
        nnz[:4] = [0, 1, min(k - 1, m), m]
    else:
        nnz[:] = m - 7
    buf = torch.from_numpy(rng.integers(0, 1 << 31, size=(n * m + offset,))
                           .astype(np.int32))
    idx = buf.to(dev)[offset:].view(n, m)
    return idx, torch.from_numpy(nnz).to(dev)


def _same_encode(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bits", B_FUSED)
@pytest.mark.parametrize("densify", [True, False])
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("m,offset", [(2048, 0), (8192, 0), (4099, 0),
                                      (2048, 1)])
def test_oph_pack_kernel_at_the_serving_buckets(cuda, bits, densify, n, m,
                                                offset):
    """The engine's row buckets and lanes at k=256, with empty rows, rows
    of fewer ids than bins, and rows that do not start 16-byte aligned
    (m=4099, or the ids one int32 past an aligned address: scalar
    loads)."""
    idx, nnz = _serving_rows(n, m, 256, seed=m + n + bits, dev=cuda,
                             offset=offset)
    a, b = OPHHash.make(256, seed=bits).params(cuda)
    assert fused_encode.oph_pack_vec(m, idx.data_ptr()) == (
        m % 4 == 0 and offset == 0)
    got = fused_encode.oph_pack(idx, nnz, a, b, k=256, bits=bits,
                                densify=densify)
    want = fused_encode.oph_pack_plain(idx, nnz, a, b, k=256, bits=bits,
                                       densify=densify)
    torch.cuda.synchronize()
    assert _same_encode(got, want)


@pytest.mark.parametrize("bits", B_FUSED)
@pytest.mark.parametrize("densify", [True, False])
@pytest.mark.parametrize("k,m", [(2, 40), (16, 300), (256, 8192),
                                 (16384, 4099)])
def test_oph_pack_kernel_every_layout(cuda, bits, densify, k, m):
    """Each threads a block and load width B2 can run at, all-empty rows
    and nnz < k included, equal to the plain version."""
    idx, nnz = _serving_rows(6, m, k, seed=k, dev=cuda)
    a, b = OPHHash.make(k, seed=3).params(cuda)
    want = fused_encode.oph_pack_plain(idx, nnz, a, b, k=k, bits=bits,
                                       densify=densify)
    for threads in (32, 256, 512, 1024):
        for vec in {False, fused_encode.oph_pack_vec(m, idx.data_ptr())}:
            got = fused_encode._oph_pack_launch(idx, nnz, a, b, k, bits,
                                                densify, threads, vec)
            torch.cuda.synchronize()
            assert _same_encode(got, want), (threads, vec)


@pytest.mark.parametrize("bits", B_FUSED)
@pytest.mark.parametrize("densify", [True, False])
def test_oph_pack_kernel_all_empty_rows_at_the_widest_k(cuda, bits,
                                                         densify):
    """k=16,384 bins: rows with no id, one id and a few (the densify
    search crosses the whole row's bitmap)."""
    idx, nnz = _serving_rows(4, 64, 16384, seed=bits, dev=cuda)
    nnz = torch.tensor([0, 1, 3, 64], dtype=torch.int32, device=cuda)
    a, b = OPHHash.make(16384, seed=bits).params(cuda)
    got = fused_encode.oph_pack(idx, nnz, a, b, k=16384, bits=bits,
                                densify=densify)
    want = fused_encode.oph_pack_plain(idx, nnz, a, b, k=16384, bits=bits,
                                       densify=densify)
    torch.cuda.synchronize()
    assert _same_encode(got, want)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits,k", [(8, 256), (1, 37), (4, 64)])
def test_packed_fwd_kernel_matches_plain(cuda, c, masked, bits, k):
    rng = np.random.default_rng(c + bits)
    n = 67
    codes = rng.integers(0, 1 << bits, size=(n, k)).astype(np.uint16)
    packed = torch.from_numpy(pack_codes(codes, bits)).to(cuda)
    weights = torch.from_numpy(
        rng.normal(size=(k, 1 << bits, c)).astype(np.float32)).to(cuda)
    empty = None
    if masked:
        mask = rng.random((n, k)) < 0.3
        mask[0] = True
        empty = torch.from_numpy(np.packbits(mask, axis=1)).to(cuda)
    kw = dict(k=k, bits=bits, empty=empty)
    got = bbit_linear.bbit_linear_packed_fwd(packed, weights, **kw)
    again = bbit_linear.bbit_linear_packed_fwd(packed, weights, **kw)
    want = bbit_linear.bbit_linear_packed_fwd_plain(packed, weights, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _packed_case(n, k, bits, c, masked, seed, dev, offset=0):
    """Packed codes, a table and (if masked) an empty mask; ``offset``
    bytes before the first packed row, so that rows start unaligned."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, size=(n, k)).astype(np.uint16)
    flat = np.concatenate([np.zeros(offset, np.uint8),
                           pack_codes(codes, bits).ravel()])
    packed = torch.from_numpy(flat).to(dev)[offset:].view(n, -1)
    weights = torch.from_numpy(
        rng.normal(size=(k, 1 << bits, c)).astype(np.float32)).to(dev)
    empty = None
    if masked:
        mask = rng.random((n, k)) < 0.3
        mask[0] = True
        empty = torch.from_numpy(np.packbits(mask, axis=1)).to(dev)
    return packed, weights, empty


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("bits,k,offset", [(8, 256, 0), (8, 36, 0),
                                           (1, 37, 0), (8, 256, 1),
                                           (4, 64, 2), (2, 600, 0),
                                           (8, 1000, 0)])
def test_packed_fwd_kernel_at_the_serving_buckets(cuda, c, masked, n, bits,
                                                  k, offset):
    """The engine's row buckets, k not a multiple of 8 (k=36 at b=8, k=37
    at b=1: a partial last group of codes), rows that start unaligned
    (byte loads), k above one 256-bin step; allclose to the plain
    version and the same bits on two calls."""
    packed, weights, empty = _packed_case(n, k, bits, c, masked,
                                          seed=n + k + c, dev=cuda,
                                          offset=offset)
    assert bbit_linear.packed_fwd_vec(bits, packed.shape[1],
                                      packed.data_ptr()) == (
        packed.shape[1] % bits == 0 and offset % bits == 0)
    kw = dict(k=k, bits=bits, empty=empty)
    got = bbit_linear.bbit_linear_packed_fwd(packed, weights, **kw)
    again = bbit_linear.bbit_linear_packed_fwd(packed, weights, **kw)
    want = bbit_linear.bbit_linear_packed_fwd_plain(packed, weights, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits,k", [(8, 256), (1, 37), (8, 36), (4, 64)])
def test_packed_fwd_kernel_every_layout(cuda, bits, k):
    """Each rows a block and load width B5 can run at gives the same bits
    (one row's sum does not depend on the block it runs in)."""
    packed, weights, empty = _packed_case(67, k, bits, 4, True, seed=k,
                                          dev=cuda)
    want = bbit_linear.bbit_linear_packed_fwd_plain(
        packed, weights, k=k, bits=bits, empty=empty)
    first = None
    for rows in (1, 2, 4, 8):
        for vec in {False, bbit_linear.packed_fwd_vec(
                bits, packed.shape[1], packed.data_ptr())}:
            got = bbit_linear._packed_fwd_launch(packed, weights, k, bits,
                                                 empty, rows, vec)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            first = got if first is None else first
            assert torch.equal(got, first), (rows, vec)


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
def test_engine_runs_through_the_kernels(cuda, scheme):
    cfg = BBitLinearConfig(k=256, b=8)
    params = init_bbit_linear(cfg, torch.Generator().manual_seed(0),
                              device=cuda)
    rng = np.random.default_rng(0)
    docs = [np.unique(rng.integers(0, 1 << 33, size=int(s)))
            for s in rng.integers(1, 3000, size=40)]
    with HashedClassifierEngine(params, cfg, scheme=scheme, device=cuda,
                                nnz_buckets=(2048, 8192),
                                row_buckets=(1, 64)) as eng:
        ops.reset_counts()
        futs = eng.submit_many(docs)
        eng.flush()
        got = np.asarray([f.result(timeout=60) for f in futs], np.float32)
        counts = ops.counts()
        want = eng.score_docs(docs)
    assert np.array_equal(got, want)
    encode = "minhash_pack" if scheme == "minwise" else "oph_pack"
    assert counts[encode] > 0 and counts["bbit_linear_packed_fwd"] > 0
    assert all(v == 0 for name, v in counts.items()
               if name.endswith("_plain"))


def _serving_docs(seed, n=128):
    """Documents across the serving lanes (1 to 8,000 ids, past 2^31)."""
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, 1 << 33, size=int(s)))
            for s in rng.integers(1, 8000, size=n)]


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
@pytest.mark.parametrize("lane", [2048, 8192])
@pytest.mark.parametrize("rows", [1, 64])
def test_dedup_host_keys_equal_the_fused_encode(cuda, scheme, lane, rows):
    """The dedup cache's host-encode bytes (its guard) equal B1's
    (minwise) or B2's (OPH) at the engine's lanes and row buckets."""
    cfg = BBitLinearConfig(k=256, b=8)
    params = init_bbit_linear(cfg, device=cuda)
    docs = [d for d in _serving_docs(lane + rows, n=400)
            if len(d) <= lane][:rows]
    assert len(docs) == rows
    from repro_torch.data.packing import pad_rows
    with HashedClassifierEngine(params, cfg, seed=1, scheme=scheme,
                                device=cuda, precompile=False,
                                nnz_buckets=(2048, 8192), dedup_cache=True,
                                row_buckets=(1, 64)) as eng:
        keys = eng._dedup_keys(docs)
        idx, nnz = pad_rows(docs, pad_to_multiple=1)
        idx = np.pad(idx, ((0, 0), (0, lane - idx.shape[1])))
        ops.reset_counts()
        packed, empty = eng.scheme.encode_packed(
            torch.from_numpy(idx).to(cuda), torch.from_numpy(nnz).to(cuda), 8)
        torch.cuda.synchronize()
        counts = ops.counts()
    encode = "minhash_pack" if scheme == "minwise" else "oph_pack"
    assert counts[encode] == 1 and counts[encode + "_plain"] == 0
    packed = packed.cpu().numpy()
    assert [k[1] for k in keys] == [row.tobytes() for row in packed]
    if scheme == "oph_zero":
        assert [k[2] for k in keys] == [row.tobytes()
                                        for row in empty.cpu().numpy()]
    else:
        assert empty is None and all(k[2] is None for k in keys)


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
def test_dedup_hit_equals_a_fresh_score_across_row_buckets(cuda, scheme):
    """A cached score equals the same document scored fresh in a 1-row
    and in a 64-row batch, bit for bit, and the hits leave the card
    alone."""
    cfg = BBitLinearConfig(k=256, b=8)
    params = init_bbit_linear(cfg, torch.Generator().manual_seed(3),
                              device=cuda)
    docs = [d for d in _serving_docs(7, n=400) if len(d) <= 2048][:64]
    with HashedClassifierEngine(params, cfg, seed=1, scheme=scheme,
                                device=cuda, nnz_buckets=(2048, 8192),
                                row_buckets=(1, 64), dedup_cache=True,
                                dedup_entries=256) as eng:
        first = [f.result(timeout=60) for f in eng.submit_many(docs)]
        runs = eng.batcher.batches_run
        ops.reset_counts()
        hits = np.asarray([f.result(timeout=60)
                           for f in eng.submit_many(docs)], np.float32)
        assert sum(ops.counts().values()) == 0
        assert eng.batcher.batches_run == runs
        assert eng.dedup.stats()["hits"] == len(docs)
        full = eng.score_docs(docs)                          # 64 rows
        one = np.concatenate([eng.score_docs([d]) for d in docs])
    assert len(docs) == 64
    assert np.array_equal(hits, np.asarray(first, np.float32))
    assert np.array_equal(hits, full) and np.array_equal(hits, one)


@pytest.mark.parametrize("scheme,encode", [("minwise", "minhash"),
                                           ("oph", "oph"),
                                           ("oph_zero", "oph")])
def test_unfused_engine_launch_counts(cuda, scheme, encode):
    """fused=False launches the raw encode (B3, B4) and the widened
    product (B7) and no plain version; oph_zero's masked product has no
    kernel, so it counts on bbit_linear_fwd_plain and nowhere else.
    Scores allclose (1e-5) to the fused path's."""
    cfg = BBitLinearConfig(k=256, b=8)
    params = init_bbit_linear(cfg, torch.Generator().manual_seed(4),
                              device=cuda)
    docs = _serving_docs(11, n=96)
    kw = dict(seed=1, scheme=scheme, device=cuda, precompile=False,
              nnz_buckets=(2048, 8192), row_buckets=(1, 64))
    with HashedClassifierEngine(params, cfg, fused=False, **kw) as eng:
        ops.reset_counts()
        futs = eng.submit_many(docs)
        eng.flush()
        got = np.asarray([f.result(timeout=60) for f in futs], np.float32)
        torch.cuda.synchronize()
        counts = ops.counts()
        assert np.array_equal(got, eng.score_docs(docs))
    with HashedClassifierEngine(params, cfg, **kw) as eng:
        want = eng.score_docs(docs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = {k for k, v in counts.items() if k.endswith("_plain") and v}
    assert counts[encode] >= 1
    assert counts["minhash_pack"] == counts["oph_pack"] == 0
    assert counts["bbit_linear_packed_fwd"] == 0
    if scheme == "oph_zero":
        assert counts["bbit_linear_fwd"] == 0
        assert plain == {"bbit_linear_fwd_plain"}
    else:
        assert counts["bbit_linear_fwd"] >= 1 and not plain


def test_launch_serve_http_on_the_card(cuda):
    """``python -m repro_torch.launch.serve --http --device cuda --port 0``
    binds, answers ``/score`` through the kernels and drains on
    SIGTERM."""
    import signal
    import subprocess
    import sys
    import threading
    from repro_torch.serving import ScoreClient
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--http",
         "--device", "cuda", "--port", "0", "--n-docs", "300",
         "--dedup-cache"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=src))
    lines, listening = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("LISTENING"):
                listening.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert listening.wait(timeout=300), lines
        _, host, port = next(ln for ln in lines
                             if ln.startswith("LISTENING")).split()
        client = ScoreClient(host, int(port), timeout=60)
        resp = client.score(_serving_docs(5, n=16))
        status = client.status()
        client.close()
        assert len(resp["scores"]) == 16
        assert np.isfinite(resp["scores"]).all()
        assert status["devices"] == ["cuda:0"]
        assert status["kernels"]["minhash_pack"] >= 1
        assert status["kernels"]["bbit_linear_packed_fwd"] >= 1
        assert all(v == 0 for name, v in status["kernels"].items()
                   if name.endswith("_plain"))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    reader.join(timeout=60)
    assert any(ln.startswith("drained clean=True") for ln in lines), lines


def _widened(n, k, bits, c, seed, dev):
    rng = np.random.default_rng(seed)
    v = 1 << bits
    codes = torch.from_numpy(
        rng.integers(0, v, size=(n, k)).astype(np.int32)).to(dev)
    weights = torch.from_numpy(
        rng.normal(size=(k, v, c)).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(dev)
    return codes, weights, dout


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("bits,k,n", [(1, 37, 67), (2, 64, 300),
                                      (4, 256, 1000), (8, 256, 4097),
                                      (12, 37, 515), (8, 256, 16000),
                                      (13, 6, 4), (16, 37, 3000)])
def test_widened_kernels_match_plain(cuda, c, bits, k, n):
    codes, weights, dout = _widened(n, k, bits, c, seed=bits + c, dev=cuda)
    v = 1 << bits
    got = bbit_linear.bbit_linear_fwd(codes, weights)
    again = bbit_linear.bbit_linear_fwd(codes, weights)
    want = bbit_linear.bbit_linear_fwd_plain(codes, weights)
    dw = bbit_linear.bbit_linear_bwd_dw(codes, dout, v)
    dw_again = bbit_linear.bbit_linear_bwd_dw(codes, dout, v)
    dw_want = bbit_linear.bbit_linear_bwd_dw_plain(codes, dout, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(dw, dw_again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, dw_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [1, 4])
def test_widened_kernels_at_the_paper_width(cuda, c):
    """configs/rcv1_bbit.py's k=500, b=16 (V=65536, 16 V tiles of dW):
    a row sums 500 terms, so B7 and B8 are held to their plain versions
    within 1e-5 of the sum of the absolute terms (+1e-6), the error
    bound of a float32 sum taken in another order, and to the same
    bytes on two calls."""
    codes, weights, dout = _widened(16000, 500, 16, c, seed=c, dev=cuda)
    v = 1 << 16
    got = bbit_linear.bbit_linear_fwd(codes, weights)
    again = bbit_linear.bbit_linear_fwd(codes, weights)
    want = bbit_linear.bbit_linear_fwd_plain(codes, weights)
    scale = bbit_linear.bbit_linear_fwd_plain(codes, weights.abs())
    dw = bbit_linear.bbit_linear_bwd_dw(codes, dout, v)
    dw_again = bbit_linear.bbit_linear_bwd_dw(codes, dout, v)
    dw_want = bbit_linear.bbit_linear_bwd_dw_plain(codes, dout, v)
    dw_scale = bbit_linear.bbit_linear_bwd_dw_plain(codes, dout.abs(), v)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(dw, dw_again)
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    assert bool(((dw - dw_want).abs() <= 1e-5 * dw_scale + 1e-6).all())


def _with_strays(codes, v, seed):
    """``codes`` with about 5 % of them moved outside [0, V)."""
    rng = np.random.default_rng(seed)
    out = codes.cpu().numpy().copy()
    stray = rng.random(out.shape) < 0.05
    out[stray] = rng.choice(np.array([-1, v, v + 7, -(1 << 20)], np.int32),
                            size=int(stray.sum()))
    return torch.from_numpy(out).to(codes.device)


@pytest.mark.parametrize("bits,k,n", [(1, 37, 4099), (8, 256, 16000),
                                      (12, 30, 515), (16, 500, 16000),
                                      (16, 3, 1), (4, 5, 0), (17, 4, 300)])
def test_dw_plan_kernel_matches_plain_plan(cuda, bits, k, n):
    """B8's plan kernel (a stable radix sort of each bin's rows by code,
    codes outside [0, V) left out, and the last pass's digit offsets)
    equals the plain plan byte for byte, at one, two and three 8-bit
    passes."""
    codes, _, _ = _widened(n, k, min(bits, 16), 1, seed=bits + k, dev=cuda)
    v = 1 << bits
    codes = _with_strays(codes, v, seed=bits)
    plan = bbit_linear.bbit_linear_dw_plan(codes, v)
    want = bbit_linear.bbit_linear_dw_plan_plain(codes, v)
    torch.cuda.synchronize()
    assert plan.perm.shape == plan.scode.shape == (k, n)
    assert all(torch.equal(a, b) for a, b in zip(plan, want))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("bits,k,n", [(1, 37, 4099), (8, 256, 16000),
                                      (16, 500, 16000), (12, 7, 33)])
def test_bwd_dw_same_bytes_from_fresh_cached_and_rebuilt_plans(cuda, c, bits,
                                                               k, n):
    """B8's dW has the same bytes from a plan just built, from the cached
    plan and from a plan built again after the cache was cleared, and
    agrees with its plain version (codes outside [0, V) included)."""
    codes, _, dout = _widened(n, k, bits, c, seed=c * bits, dev=cuda)
    v = 1 << bits
    codes = _with_strays(codes, v, seed=c)
    fn = bbit_linear.bbit_linear_bwd_dw
    fn.clear_plans()
    builds = fn.plan_builds.value
    fresh = fn(codes, dout, v)
    cached = fn(codes, dout, v)
    assert fn.plan_builds.value == builds + 1
    fn.clear_plans()
    rebuilt = fn(codes, dout, v)
    assert fn.plan_builds.value == builds + 2
    want = bbit_linear.bbit_linear_bwd_dw_plain(codes, dout, v)
    scale = bbit_linear.bbit_linear_bwd_dw_plain(codes, dout.abs(), v)
    torch.cuda.synchronize()
    assert torch.equal(fresh, cached) and torch.equal(fresh, rebuilt)
    assert bool(((fresh - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("n", [1, 4097])
@pytest.mark.parametrize("bits,k,c", [(8, 37, 1), (8, 300, 1), (9, 70, 1),
                                      (4, 130, 3)])
def test_fwd_kernel_with_a_ragged_last_bin_group(cuda, n, bits, k, c):
    """B7 where k is not a multiple of its bin group (32 bins where a
    32-bin slice of the table fits L1): the partial logits of each
    group, added in group order, match the plain versions, and the same
    bytes on two calls; codes outside [0, V) add nothing."""
    codes, weights, _ = _widened(n, k, bits, c, seed=n + k, dev=cuda)
    v = 1 << bits
    group = bbit_linear.fwd_layout(k, v, c)
    assert 1 < -(-k // group) and k % group != 0
    codes = _with_strays(codes, v, seed=k)
    got = bbit_linear.bbit_linear_fwd(codes, weights)
    again = bbit_linear.bbit_linear_fwd(codes, weights)
    want = bbit_linear.bbit_linear_fwd_plain(codes, weights)
    grouped = bbit_linear.bbit_linear_fwd_grouped_plain(codes, weights)
    scale = bbit_linear.bbit_linear_fwd_plain(codes, weights.abs())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for ref in (want, grouped):
        assert bool(((got - ref).abs() <= 1e-5 * scale + 1e-6).all())


def _dw_within(got, want, scale):
    """dW against its plain version: within 1e-5 of each bin's sum of
    absolute terms (+1e-6), the bound of a float32 sum taken in another
    order (chip_smoke.py's DW_SUM_TOL)."""
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def _packed_dw_case(n, k, bits, c, masked, seed, dev, same=False):
    """Packed codes (every row the same codes if ``same``), dout (n, c) and
    (if masked) an empty mask with about 30 % of the bins marked."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, size=(n, k)).astype(np.uint16)
    if same:
        codes[:] = codes[0]
    packed = torch.from_numpy(pack_codes(codes, bits)).to(dev)
    dout = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(dev)
    empty = None
    if masked:
        mask = rng.random((n, k)) < 0.3
        mask[0] = True
        empty = torch.from_numpy(np.packbits(mask, axis=1)).to(dev)
    return packed, dout, empty


def _check_packed_dw(packed, dout, empty, vsize, k, bits, close=False):
    """The same bits on two calls, within DW_SUM_TOL of the plain version
    (and, if ``close``, within rtol = atol = 1e-5 of it too)."""
    kw = dict(k=k, bits=bits, empty=empty)
    got = bbit_linear.bbit_linear_packed_bwd_dw(packed, dout, vsize, **kw)
    again = bbit_linear.bbit_linear_packed_bwd_dw(packed, dout, vsize, **kw)
    want = bbit_linear.bbit_linear_packed_bwd_dw_plain(packed, dout, vsize,
                                                       **kw)
    scale = bbit_linear.bbit_linear_packed_bwd_dw_plain(packed, dout.abs(),
                                                        vsize, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert _dw_within(got, want, scale)
    if close:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# (bits, k, n): the first six from before the stream-batch cases, then one
# row, a partial 32-row group, the stream batch (1,024), a partial last
# group past it and the training rows (16,000), k not a multiple of the 8
# bins a block
_PACKED_DW_FIRST = [(1, 37, 67), (2, 64, 300), (4, 256, 1000),
                    (8, 256, 4097), (8, 256, 1024), (8, 256, 16000)]
_PACKED_DW_CASES = _PACKED_DW_FIRST + [
    (bits, k, n) for bits, k in [(1, 37), (2, 64), (4, 100), (8, 256),
                                 (8, 37)]
    for n in [1, 31, 1024, 4097, 16000]
    if (bits, k, n) not in _PACKED_DW_FIRST]


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits,k,n", _PACKED_DW_CASES)
def test_packed_bwd_kernel_matches_plain(cuda, c, masked, bits, k, n):
    """B6 with C in {1, 3, 4}, with and without the empty mask: the same
    bits on two calls and within 1e-5 of each bin's sum of absolute terms
    of the plain version; the first six shapes also within rtol = atol =
    1e-5 of it (at a few bits and thousands of rows a value sums thousands
    of terms, and a reordered float32 sum of them misses a flat 1e-5)."""
    packed, dout, empty = _packed_dw_case(n, k, bits, c, masked,
                                          seed=c + bits + masked, dev=cuda)
    _check_packed_dw(packed, dout, empty, 1 << bits, k, bits,
                     close=(bits, k, n) in _PACKED_DW_FIRST)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [31, 1024, 4097])
def test_packed_bwd_kernel_beyond_a_4096_table(cuda, masked, n):
    """V=8,192 at b=8: the values from 256 on are zeros."""
    packed, dout, empty = _packed_dw_case(n, 40, 8, 2, masked, seed=n,
                                          dev=cuda)
    _check_packed_dw(packed, dout, empty, 8192, 40, 8)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits,n", [(8, 1024), (8, 16000), (1, 4097)])
def test_packed_bwd_kernel_every_row_the_same_code(cuda, masked, bits, n):
    """Every row holds the same code in each bin: in each 32-row group the
    lowest lane of the code sums 4 rows a step, over 8 steps."""
    packed, dout, empty = _packed_dw_case(n, 256, bits, 1, masked, seed=bits,
                                          dev=cuda, same=True)
    _check_packed_dw(packed, dout, empty, 1 << bits, 256, bits)


@pytest.mark.parametrize("bits,k,n", [(8, 256, 1024), (4, 37, 4097),
                                      (1, 64, 100)])
def test_packed_bwd_kernel_every_layout(cuda, bits, k, n):
    """Each warps a block and cluster of blocks along the rows B6 can run
    at, with and without one load a row's codes: within 1e-5 of each
    bin's sum of absolute terms, the same bits on two calls."""
    packed, dout, empty = _packed_dw_case(n, k, bits, 3, True, seed=k,
                                          dev=cuda)
    kw = dict(k=k, bits=bits, empty=empty)
    v = 1 << bits
    want = bbit_linear.bbit_linear_packed_bwd_dw_plain(packed, dout, v, **kw)
    scale = bbit_linear.bbit_linear_packed_bwd_dw_plain(packed, dout.abs(), v,
                                                        **kw)
    for warps in (1, 2, 8, 16):
        for parts in (1, 2, 4, 8):
            for vec in {False, bbit_linear.packed_fwd_vec(
                    bits, packed.shape[1], packed.data_ptr())}:
                run = lambda: bbit_linear._packed_dw_launch(
                    packed, dout, v, k, bits, empty, warps, parts, vec)
                got, again = run(), run()
                torch.cuda.synchronize()
                assert torch.equal(got, again), (warps, parts, vec)
                assert _dw_within(got, want, scale), (warps, parts, vec)


def _vw_rows(n, mx, seed, dev, ones):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 31, size=(n, mx)).astype(np.int32)
    val = (np.ones((n, mx), np.float32) if ones
           else rng.normal(size=(n, mx)).astype(np.float32))
    nnz = rng.integers(0, mx + 1, size=(n,)).astype(np.int32)
    nnz[:4] = [0, mx, mx + 5, -3]         # empty, full, beyond M, negative
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev),
            torch.from_numpy(nnz).to(dev))


# both designs of vw_layout: lanes up to m=256 (the threshold), slices
# above, several a row at m=65536
@pytest.mark.parametrize("m", [1, 2, 64, 256, 512, 1024, 4096, 16384,
                               65536])
@pytest.mark.parametrize("ones", [True, False])
def test_vw_sketch_kernel_matches_plain(cuda, m, ones):
    idx, val, nnz = _vw_rows(37, 3000, seed=m, dev=cuda, ones=ones)
    got = vw_sketch.vw_sketch(idx, val, nnz, m, seed=2)
    again = vw_sketch.vw_sketch(idx, val, nnz, m, seed=2)
    want = vw_sketch.vw_sketch_plain(idx, val, nnz, m, seed=2)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if ones:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m", [64, 16384])
@pytest.mark.parametrize("mx", [512, 4480])
def test_vw_sketch_kernel_one_bucket_row(cuda, m, mx):
    """A row whose ids all hash to one bucket: with ones byte for byte,
    with random values within 1e-5 of the sum of |terms| (+1e-6), the
    bound of a reordered float32 sum, and the same bits on two calls."""
    idx, val, nnz = _vw_rows(8, mx, seed=mx, dev=cuda, ones=False)
    idx[5] = 12345
    nnz[5] = mx
    for v in (torch.ones_like(val), val):
        got = vw_sketch.vw_sketch(idx, v, nnz, m, seed=2)
        want = vw_sketch.vw_sketch_plain(idx, v, nnz, m, seed=2)
        live = (torch.arange(mx, device=cuda)[None, :]
                < nnz.to(torch.int64)[:, None])
        scale = vw_sketch.scatter_rows(
            vw_sketch.bucket_words(idx, 2) & (m - 1),
            torch.where(live, v.abs(), 0.0), m)
        torch.cuda.synchronize()
        assert int((got[5] != 0).sum()) == 1
        assert torch.equal(got, vw_sketch.vw_sketch(idx, v, nnz, m, seed=2))
        assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    assert torch.equal(vw_sketch.vw_sketch(idx, torch.ones_like(val), nnz,
                                           m, seed=2).view(torch.int32),
                       vw_sketch.vw_sketch_plain(
                           idx, torch.ones_like(val), nnz, m,
                           seed=2).view(torch.int32))


@pytest.mark.parametrize("b", [8, 16])
def test_training_path_runs_through_the_kernels(cuda, b):
    from repro_torch.models.linear import BBitLinearConfig as Cfg
    from repro_torch.train.linear_trainer import train_bbit_liblinear
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 1 << b, size=(600, 64)).astype(np.uint16)
    labels = (codes[:, 0] >= 1 << (b - 1)).astype(np.int32)
    ops.reset_counts()
    res = train_bbit_liblinear(codes[:400], labels[:400], codes[400:],
                               labels[400:], Cfg(k=64, b=b), max_iter=5,
                               device=cuda)
    counts = ops.counts()
    assert counts["bbit_linear_fwd"] > 0 and counts["bbit_linear_bwd_dw"] > 0
    assert counts["bbit_linear_fwd_plain"] == 0
    assert counts["bbit_linear_bwd_dw_plain"] == 0
    assert res.train_acc > 0.9


@pytest.mark.parametrize("k,n,m", [(1, 64, 100), (30, 37, 3000),
                                   (500, 64, 8192), (256, 1, 50),
                                   (500, 1, 1)])
def test_minhash_kernel_matches_plain(cuda, k, n, m):
    idx, nnz = (_rows(n, m, seed=k + n, dev=cuda) if n >= 3
                else _full_rows(n, m, seed=k, dev=cuda))
    a, b = MultiplyShiftHash.make(k, seed=k).params(cuda)
    got = minhash.minhash(idx, nnz, a, b)
    again = minhash.minhash(idx, nnz, a, b)
    want = minhash.minhash_plain(idx, nnz, a, b)
    torch.cuda.synchronize()
    assert got.shape == (n, k) and got.dtype == torch.int32
    assert torch.equal(got, again) and torch.equal(got, want)
    if n >= 3:
        assert bool((got[0] == -1).all())         # nnz=0: 0xFFFFFFFF


@pytest.mark.parametrize("k,n,m", [(2, 64, 100), (256, 64, 8192),
                                   (256, 1, 40), (16384, 8, 2048)])
def test_oph_kernel_matches_plain(cuda, k, n, m):
    idx, nnz = (_rows(n, m, seed=k + n, dev=cuda) if n >= 3
                else _full_rows(n, m, seed=k, dev=cuda))
    a, b = OPHHash.make(k, seed=k).params(cuda)
    got = oph.oph(idx, nnz, a, b, k=k)
    again = oph.oph(idx, nnz, a, b, k=k)
    want = oph.oph_plain(idx, nnz, a, b, k=k)
    torch.cuda.synchronize()
    assert got.shape == (n, k) and got.dtype == torch.int32
    assert torch.equal(got, again) and torch.equal(got, want)
    if n >= 3:
        assert bool((got[0] == -1).all())         # empty row: all sentinel


# w: 16-byte loads (16, 256, 2048), 4-byte (1000), bytes (1, 3, 37, 45,
# 250)
@pytest.mark.parametrize("n,w", [
    (n, w) for n in (0, 1, 3, 4099, 20000)
    for w in (1, 3, 16, 45, 250, 256, 1000, 2048)]
    + [(37, 3), (301, 45), (64, 2048), (5, 37)])
def test_hamming_kernel_matches_plain(cuda, n, w):
    rng = np.random.default_rng(n + w)
    cands = torch.from_numpy(
        rng.integers(0, 256, size=(n, w)).astype(np.uint8)).to(cuda)
    query = (cands[n // 2].clone() if n else torch.from_numpy(
        rng.integers(0, 256, size=w).astype(np.uint8)).to(cuda))
    got = hamming.hamming_distance(query, cands)
    again = hamming.hamming_distance(query, cands)
    want = hamming.hamming_distance_plain(query, cands)
    torch.cuda.synchronize()
    assert got.shape == (n,) and got.dtype == torch.int32
    assert torch.equal(got, again) and torch.equal(got, want)
    if n:
        assert int(got[n // 2]) == 0
    if n > 1:                     # rows from the second on: another base
        assert torch.equal(hamming.hamming_distance(query, cands[1:]),
                           want[1:])
    # rows that start one byte past an aligned base, and a query too
    flat = torch.zeros(n * w + 2, dtype=torch.uint8, device=cuda)
    flat[1:1 + n * w] = cands.reshape(-1)
    odd = flat[1:1 + n * w].view(n, w)
    qbuf = torch.zeros(w + 1, dtype=torch.uint8, device=cuda)
    qbuf[1:] = query
    assert qbuf[1:].data_ptr() % 2 == 1 and (not n or odd.data_ptr() % 2)
    assert torch.equal(hamming.hamming_distance(qbuf[1:], odd), want)


@pytest.mark.parametrize("k,b", [(24, 3), (30, 12)])
def test_hamming_topk_launches_the_kernel_at_any_b(cuda, k, b):
    """B10 popcounts whole bytes, so it serves codes that straddle them:
    the ranking at b=3 and b=12 launches it and equals its plain
    version's."""
    rng = np.random.default_rng(k * b)
    codes = rng.integers(0, 1 << b, size=(300, k)).astype(np.uint16)
    codes[7] = codes[3]                       # a tie with the query's twin
    cands = torch.from_numpy(pack_codes(codes, b)).to(cuda)
    query = cands[3].clone()
    ops.reset_counts()
    idx, sims = ops.hamming_topk(query, cands, k=k, bits=b, topk=10)
    counts = ops.counts()
    assert counts["hamming_distance"] == 1
    assert counts["hamming_distance_plain"] == 0
    want = hamming.hamming_distance_plain(query, cands)
    assert torch.equal(hamming.hamming_distance(query, cands), want)
    order = torch.sort(want.cpu(), stable=True).indices[:10]
    assert torch.equal(idx.cpu(), order.to(torch.int32))
    assert idx[:2].tolist() == [3, 7] and bool((sims[:2] == 1.0).all())


def test_raw_encode_and_search_run_through_the_kernels(cuda):
    from repro_torch.core.bbit import pack_codes
    from repro_torch.core.oph import split_zero_codes
    from repro_torch.data.hashed_dataset import (preprocess_rows,
                                                 preprocess_rows_packed)
    from repro_torch.retrieval import BandedLSHIndex
    rng = np.random.default_rng(1)
    docs = [np.unique(rng.integers(0, 1 << 33, size=int(s)))
            for s in rng.integers(1, 3000, size=50)]
    ops.reset_counts()
    wide = preprocess_rows(docs, k=500, b=16, seed=1, chunk=16, device=cuda)
    zero = preprocess_rows(docs, k=64, b=12, scheme="oph_zero", chunk=16,
                           device=cuda)
    packed, _ = preprocess_rows_packed(docs, k=64, b=8, scheme="oph",
                                       device=cuda)
    index = BandedLSHIndex(k=64, b=8, rows_per_band=4, device=cuda)
    index.insert(list(range(len(docs))), packed)
    ids, sims = index.query(packed[7], top_k=3)
    counts = ops.counts()
    assert ids[0] == 7 and sims[0] == 1.0
    assert counts["minhash"] == 4 and counts["oph"] == 4
    assert counts["hamming_distance"] == 1
    assert all(v == 0 for name, v in counts.items()
               if name.endswith("_plain"))
    assert np.array_equal(wide, preprocess_rows(docs, k=500, b=16, seed=1,
                                                chunk=16, device="cpu"))
    assert np.array_equal(zero, preprocess_rows(
        docs, k=64, b=12, scheme="oph_zero", chunk=16, device="cpu"))
    codes = preprocess_rows(docs, k=64, b=8, scheme="oph", device=cuda)
    assert np.array_equal(packed, pack_codes(split_zero_codes(codes)[0], 8))


# ------------------------------------------------- the streaming path ----
STREAM_CORPUS = dict(seed=11, topic_tokens=150, background_frac=0.35,
                     max_pairs_per_doc=4000, max_triples_per_doc=2000)
STREAM_FIT = dict(epochs=2, batch_size=64, lr=5e-3, seed=0)


@pytest.fixture(scope="module")
def stream_archives(tmp_path_factory):
    """tests/test_streaming.py's fixture (600 documents, seed 11, the
    first 400 in 5 shards at k=64, b=8), oph and oph_zero, written on the
    card; each archive's bytes equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from repro_torch.data.hashed_dataset import preprocess_and_save
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    rows, labels = generate_arrays(600, SynthRcv1Config(**STREAM_CORPUS))
    out = {}
    for scheme in ("oph", "oph_zero"):
        d = tmp_path_factory.mktemp(scheme)
        ops.reset_counts()
        for dev in ("cuda", "cpu"):
            preprocess_and_save(str(d / dev), rows[:400], labels[:400],
                                k=64, b=8, scheme=scheme, seed=1,
                                n_shards=5, chunk=128, device=dev)
            if dev == "cuda":
                counts = ops.counts()
                assert counts["oph_pack"] == 4
                assert counts["oph_pack_plain"] == 0
        for name in sorted(os.listdir(d / "cpu")):
            if name.endswith(".npy"):
                assert ((d / "cuda" / name).read_bytes()
                        == (d / "cpu" / name).read_bytes()), name
        out[scheme] = str(d / "cuda")
    return out


def _stream_close(card, cpu):
    for name in ("bias", "table"):
        torch.testing.assert_close(card[name].cpu(), cpu[name], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("scheme", ["oph", "oph_zero"])
def test_fit_streaming_on_the_card_matches_the_cpu(cuda, stream_archives,
                                                   scheme, optimizer):
    from repro_torch.models.linear import BBitLinearConfig as Cfg
    from repro_torch.train.streaming import fit_streaming
    root = stream_archives[scheme]
    kw = dict(STREAM_FIT, optimizer=optimizer)
    ops.reset_counts()
    card = fit_streaming(root, Cfg(k=64, b=8), device=cuda, **kw)
    counts = ops.counts()
    cpu = fit_streaming(root, Cfg(k=64, b=8), device="cpu", **kw)
    assert counts["bbit_linear_packed_fwd"] == card.n_steps == 20
    assert counts["bbit_linear_packed_bwd_dw"] == card.n_steps
    assert all(v == 0 for name, v in counts.items()
               if name.endswith("_plain"))
    assert card.params["table"].device.type == "cuda"
    assert (card.n_steps, card.examples_seen) == (cpu.n_steps,
                                                  cpu.examples_seen)
    assert abs(card.progressive_acc - cpu.progressive_acc) <= 1e-3
    _stream_close(card.params, cpu.params)
    _stream_close(card.avg_params, cpu.avg_params)


def test_fit_streaming_prefetch_and_resume_are_bitwise_on_the_card(
        cuda, stream_archives, tmp_path):
    """Depths 0, 1 and 2 (the batches copied on a side stream from the
    prefetch thread, or inline) and a resume after 3 shards give the same
    bits."""
    from repro_torch.models.linear import BBitLinearConfig as Cfg
    from repro_torch.train.metrics import trees_bitwise_equal
    from repro_torch.train.streaming import fit_streaming
    root = stream_archives["oph_zero"]
    cfg = Cfg(k=64, b=8)
    runs = [fit_streaming(root, cfg, prefetch=depth, device=cuda,
                          **STREAM_FIT) for depth in (0, 1, 2)]
    ck = str(tmp_path / "ck")
    part = fit_streaming(root, cfg, ckpt_dir=ck, stop_after_shards=3,
                         prefetch=2, device=cuda, **STREAM_FIT)
    assert not part.completed
    runs.append(fit_streaming(root, cfg, ckpt_dir=ck, prefetch=0,
                              device=cuda, **STREAM_FIT))
    for other in runs[1:]:
        assert trees_bitwise_equal(runs[0].params, other.params)
        assert trees_bitwise_equal(runs[0].avg_params, other.avg_params)
        assert (other.n_steps, other.examples_seen, other.progressive_acc) \
            == (runs[0].n_steps, runs[0].examples_seen,
                runs[0].progressive_acc)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("valid_rows", [1, 976, 1024])
def test_packed_kernels_on_a_padded_dp_slot(cuda, masked, valid_rows):
    """One shard slot of the dp step at the stream batch (1,024 rows, k=256,
    b=8): its rows past ``valid_rows`` are all-zero padding with dout 0.
    B5 allclose 1e-5 to its plain version, B6 within each bin's sum of
    absolute terms and the same bits twice."""
    k, bits, n = 256, 8, 1024
    packed, weights, empty = _packed_case(n, k, bits, 1, masked,
                                          seed=valid_rows, dev=cuda)
    packed[valid_rows:] = 0
    if empty is not None:
        empty[valid_rows:] = 0
    kw = dict(k=k, bits=bits, empty=empty)
    got = bbit_linear.bbit_linear_packed_fwd(packed, weights, **kw)
    want = bbit_linear.bbit_linear_packed_fwd_plain(packed, weights, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dout = torch.randn((n, 1), generator=torch.Generator().manual_seed(1)
                       ).to(cuda)
    dout[valid_rows:] = 0.0
    _check_packed_dw(packed, dout, empty, 1 << bits, k, bits)


def test_dp_fit_streaming_on_the_card_matches_the_cpu(cuda, stream_archives):
    """fit_streaming folding two logical slots (B5 and B6 once a slot a
    step, no plain call) against the same fit on the CPU, and with the
    int8 gradient exchange."""
    from repro_torch.models.linear import BBitLinearConfig as Cfg
    from repro_torch.train.streaming import fit_streaming
    root = stream_archives["oph_zero"]
    kw = dict(STREAM_FIT, data_parallel=2, elastic=True)
    ops.reset_counts()
    card = fit_streaming(root, Cfg(k=64, b=8), device=cuda, **kw)
    counts = ops.counts()
    cpu = fit_streaming(root, Cfg(k=64, b=8), device="cpu", **kw)
    assert counts["bbit_linear_packed_fwd"] == 2 * card.n_steps
    assert counts["bbit_linear_packed_bwd_dw"] == 2 * card.n_steps
    assert all(v == 0 for name, v in counts.items()
               if name.endswith("_plain"))
    assert (card.n_steps, card.examples_seen) == (cpu.n_steps,
                                                  cpu.examples_seen)
    assert card.topology_lineage[0]["physical"] == 1
    _stream_close(card.params, cpu.params)
    _stream_close(card.avg_params, cpu.avg_params)
    comp = fit_streaming(root, Cfg(k=64, b=8), device=cuda, grad_compress=8,
                         **kw)
    assert comp.completed and comp.params["table"].device.type == "cuda"


@pytest.mark.parametrize("scheme,packed,b", [
    ("oph", True, 8), ("oph_zero", True, 8), ("minwise", True, 4),
    ("oph_zero", False, 12), ("minwise", False, 16)])
def test_stream_encoded_pinned_matches_the_cpu(cuda, scheme, packed, b):
    """PIPELINE_DEPTH chunks in flight through pinned buffers give the
    CPU's bytes."""
    from repro_torch.data.hashed_dataset import _stream_encoded
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    rows, _ = generate_arrays(300, SynthRcv1Config(**STREAM_CORPUS))

    def run(dev):
        return [tuple(None if x is None else np.array(x) for x in ev)
                for ev in _stream_encoded(
                    rows, 64, b, scheme=scheme, family="multiply_shift",
                    seed=3, chunk=64, packed=packed, dev=torch.device(dev))]

    want, got = run("cpu"), run(cuda)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert (x is None) == (y is None)
            assert x is None or np.array_equal(x, y)


def test_train_bbit_sgd_on_the_card_matches_the_cpu(cuda):
    """In-memory SGD through B7/B8: one B8 plan per minibatch (each is a
    new codes tensor), parameters allclose to the CPU's."""
    from repro_torch.models.linear import BBitLinearConfig as Cfg
    from repro_torch.train.linear_trainer import train_bbit_sgd
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256, size=(600, 64)).astype(np.uint16)
    labels = (codes[:, :4].sum(axis=1) > 510).astype(np.int32)
    kw = dict(epochs=2, batch_size=64, lr=5e-3)
    ops.reset_counts()
    card = train_bbit_sgd(codes[:400], labels[:400], codes[400:],
                          labels[400:], Cfg(k=64, b=8), device=cuda, **kw)
    counts = ops.counts()
    cpu = train_bbit_sgd(codes[:400], labels[:400], codes[400:],
                         labels[400:], Cfg(k=64, b=8), device="cpu", **kw)
    assert card.n_iter == cpu.n_iter == 14
    assert counts["bbit_linear_bwd_dw"] == 14
    assert counts["bbit_linear_bwd_dw_plans"] == 14
    assert counts["bbit_linear_fwd"] == 14 + 2      # steps + two evals
    assert all(v == 0 for name, v in counts.items()
               if name.endswith("_plain"))
    _stream_close(card.params, cpu.params)
    assert abs(card.test_acc - cpu.test_acc) <= 1 / 200


# ---------------------------------------------------------------------------
# B1 at every b from 1 to 16 (codes that straddle bytes), the paper's
# archive at k=500, b=16, and the cost model's profile on the card
# ---------------------------------------------------------------------------
B_EVERY = tuple(range(1, 17))


@pytest.mark.parametrize("bits", B_EVERY)
@pytest.mark.parametrize("k", [8, 37, 256, 500])
@pytest.mark.parametrize("n,m", [(1, 2048), (64, 2048), (1024, 300)])
def test_minhash_pack_kernel_at_every_b(cuda, bits, k, n, m):
    """B1 at every b in [1, 16], k from 8 to the paper's 500 (ragged
    against every block's lanes), at one row, the engine's 64 and a
    1,024-row chunk, with nnz 0, a negative nnz, one above m and ragged
    rows: the plain version's bytes."""
    idx, nnz = _minwise_rows(n, m, seed=bits * 31 + k + n, dev=cuda)
    if n == 1:
        nnz = torch.zeros_like(nnz) if bits % 2 else nnz
    a, b = MultiplyShiftHash.make(k, seed=bits).params(cuda)
    got = fused_encode.minhash_pack(idx, nnz, a, b, bits=bits)
    want = fused_encode.minhash_pack_plain(idx, nnz, a, b, bits=bits)
    torch.cuda.synchronize()
    assert got.shape == (n, (k * bits + 7) // 8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [3, 6, 12, 16])
@pytest.mark.parametrize("k,m,offset", [(500, 4099, 0), (37, 300, 1)])
def test_minhash_pack_kernel_every_layout_across_bytes(cuda, bits, k, m,
                                                       offset):
    """Every launch layout of B1 whose block holds whole bytes of codes
    that straddle bytes (lanes a multiple of 8 / gcd(b, 8))."""
    idx, nnz = _minwise_rows(6, m, seed=k + bits, dev=cuda, offset=offset)
    a, b = MultiplyShiftHash.make(k, seed=3).params(cuda)
    want = fused_encode.minhash_pack_plain(idx, nnz, a, b, bits=bits)
    for lpt in (1, 2, 4, 8):
        for lt in (1, 2, 4, 8, 16, 32):
            if lpt * lt * bits % 8:
                continue
            for warps in (1, 16):
                got = fused_encode._minhash_pack_launch(
                    idx, nnz, a, b, bits, lpt, lt, warps, False)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (lpt, lt, warps)


def test_preprocess_and_save_at_the_paper_width_on_the_card(cuda, tmp_path):
    """configs/rcv1_bbit.py's k=500, b=16: the archive written through B1
    (no plain call) has the CPU's bytes, and launch/fsck.py passes it."""
    from repro_torch.configs.rcv1_bbit import CONFIG
    from repro_torch.data.hashed_dataset import preprocess_and_save
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    from repro_torch.launch.fsck import fsck_archive
    rows, labels = generate_arrays(300, SynthRcv1Config(**STREAM_CORPUS))
    for dev in ("cuda", "cpu"):
        ops.reset_counts()
        preprocess_and_save(str(tmp_path / dev), rows, labels, k=CONFIG.k,
                            b=CONFIG.b, seed=0, n_shards=4, chunk=128,
                            device=dev)
        counts = ops.counts()
        if dev == "cuda":
            assert counts["minhash_pack"] == 3
            assert counts["minhash_pack_plain"] == 0
    for name in sorted(os.listdir(tmp_path / "cpu")):
        if name.endswith(".npy"):
            assert ((tmp_path / "cuda" / name).read_bytes()
                    == (tmp_path / "cpu" / name).read_bytes()), name
    report = fsck_archive(str(tmp_path / "cuda"))
    assert report["verified"] == 4 and not report["corrupt"]


def test_calibrate_profile_sizes_the_engine_on_the_card(cuda, tmp_path):
    """perf.calibrate on the card (kernel arms only), a profile keyed to
    this card, and an engine built from it: every choice a hit or the
    static rule, no plain call, scores equal to the static grid's."""
    from repro_torch import perf
    perf.reset()
    try:
        table = perf.calibrate(k=64, b_values=(8,), schemes=("oph",),
                               encode_rows=(4,), encode_widths=(256,),
                               logits_rows=(16,), max_batch=8,
                               nnz_buckets=(128, 512), trials=2,
                               budget_s=120.0, seed=0, device=cuda)
        assert table.fingerprint["backend"] == "cuda"
        assert table.fingerprint["device_kind"] == \
            torch.cuda.get_device_name(0)
        assert all(key.split("|")[1] in ("kernel", "fused")
                   for key in table.entries)
        path = str(tmp_path / "p.json")
        table.save(path)
        assert perf.maybe_load_profile(path)
        cfg = BBitLinearConfig(k=64, b=8)
        params = init_bbit_linear(cfg, torch.Generator().manual_seed(0),
                                  device=cuda)
        docs = [np.unique(np.random.default_rng(i).integers(
            0, 1 << 30, size=50 + 40 * i)) for i in range(12)]
        kw = dict(scheme="oph", device=cuda, max_batch=8,
                  nnz_buckets=(128, 512))
        ops.reset_counts()
        with HashedClassifierEngine(params, cfg, row_buckets=None,
                                    **kw) as eng:
            got = eng.score_docs(docs)
            st = eng.stats()
        counts = ops.counts()
        with HashedClassifierEngine(params, cfg, row_buckets=(1, 2, 4, 8),
                                    **kw) as eng:
            want = eng.score_docs(docs)
        assert st["dispatch"]["profile_loaded"]
        assert st["dispatch"]["hits"] > 0
        assert set(st["lane_caps"]) == {"128", "512"}
        assert all(v == 0 for name, v in counts.items()
                   if name.endswith("_plain"))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    finally:
        perf.reset()
