"""The port's CUDA kernels against their plain torch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one; the
file imports nothing of JAX, so it runs on a machine that has only
torch:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Integer outputs (B1, B2) must be equal.  B5–B8 sum in another order than
torch, so they are held to allclose at 1e-5 and to run-to-run equality
(B6 and B8 bit-identical on two calls).  B9 with values of ones must
equal its plain version byte for byte; with random values allclose at
1e-5 and run-to-run equal."""
import numpy as np
import pytest
import torch

from repro_torch.core.oph import OPHHash
from repro_torch.core.universal_hash import MultiplyShiftHash
from repro_torch.core.bbit import pack_codes
from repro_torch.kernels import bbit_linear, fused_encode, ops, vw_sketch
from repro_torch.models.linear import BBitLinearConfig, init_bbit_linear
from repro_torch.serving import HashedClassifierEngine

pytestmark = pytest.mark.cuda

B_FUSED = (1, 2, 4, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


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
                                      (12, 37, 515), (8, 256, 16000)])
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
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits,k,n", [(1, 37, 67), (2, 64, 300),
                                      (4, 256, 1000), (8, 256, 4097),
                                      (8, 256, 1024), (8, 256, 16000)])
def test_packed_bwd_kernel_matches_plain(cuda, c, masked, bits, k, n):
    rng = np.random.default_rng(c + bits + masked)
    codes = rng.integers(0, 1 << bits, size=(n, k)).astype(np.uint16)
    packed = torch.from_numpy(pack_codes(codes, bits)).to(cuda)
    dout = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(cuda)
    empty = None
    if masked:
        mask = rng.random((n, k)) < 0.3
        mask[0] = True
        empty = torch.from_numpy(np.packbits(mask, axis=1)).to(cuda)
    kw = dict(k=k, bits=bits, empty=empty)
    got = bbit_linear.bbit_linear_packed_bwd_dw(packed, dout, 1 << bits, **kw)
    again = bbit_linear.bbit_linear_packed_bwd_dw(packed, dout, 1 << bits,
                                                  **kw)
    want = bbit_linear.bbit_linear_packed_bwd_dw_plain(packed, dout,
                                                       1 << bits, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _vw_rows(n, mx, seed, dev, ones):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 31, size=(n, mx)).astype(np.int32)
    val = (np.ones((n, mx), np.float32) if ones
           else rng.normal(size=(n, mx)).astype(np.float32))
    nnz = rng.integers(0, mx + 1, size=(n,)).astype(np.int32)
    nnz[0] = 0
    nnz[1] = mx
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev),
            torch.from_numpy(nnz).to(dev))


@pytest.mark.parametrize("m", [2, 64, 1024, 16384, 65536])
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


def test_training_path_runs_through_the_kernels(cuda):
    from repro_torch.models.linear import BBitLinearConfig as Cfg
    from repro_torch.train.linear_trainer import train_bbit_liblinear
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 256, size=(600, 64)).astype(np.uint16)
    labels = (codes[:, 0] > 127).astype(np.int32)
    ops.reset_counts()
    res = train_bbit_liblinear(codes[:400], labels[:400], codes[400:],
                               labels[400:], Cfg(k=64, b=8), max_iter=5,
                               device=cuda)
    counts = ops.counts()
    assert counts["bbit_linear_fwd"] > 0 and counts["bbit_linear_bwd_dw"] > 0
    assert counts["bbit_linear_fwd_plain"] == 0
    assert counts["bbit_linear_bwd_dw_plain"] == 0
    assert res.train_acc > 0.9
