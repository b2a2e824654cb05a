"""Port vs reference: the fused encode kernels B1 (minwise) and B2 (OPH).

On the CPU the port's wrappers run their plain torch versions; these
must equal the reference's Pallas kernels (interpret mode) byte for
byte — packed codes and empty masks — over b ∈ {1, 2, 4, 8}, ragged
nnz (nnz < k and nnz = 0 included), k not a multiple of 8, and both
OPH variants.  At k = 256 the reference is its host encode
(``encode_packed_numpy``), since interpret mode is slow there.  The
CUDA kernels themselves are tested in test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.oph import OPHHash as JOPHHash
from repro.core.schemes import make_scheme as j_make_scheme
from repro.kernels.fused_encode import minhash_pack_pallas, oph_pack_pallas

from repro_torch.core.schemes import make_scheme as t_make_scheme
from repro_torch.core.universal_hash import words_to_int32
from repro_torch.kernels import fused_encode, ops

B_FUSED = (1, 2, 4, 8)


def _rows(n, m, seed, zero_row=True):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 31, size=(n, m)).astype(np.int32)
    nnz = rng.integers(1, m + 1, size=(n,)).astype(np.int32)
    nnz[1] = min(3, m)               # fewer nonzeros than bins
    if zero_row:
        nnz[0] = 0
    return idx, nnz


def _minwise_params(k, seed):
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 1 << 32, size=k, dtype=np.uint64) | 1
         ).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=k, dtype=np.uint64).astype(np.uint32)
    return a, b


@pytest.mark.parametrize("k", [8, 37, 64])
@pytest.mark.parametrize("bits", B_FUSED)
def test_minhash_pack_plain_matches_pallas(k, bits):
    idx, nnz = _rows(5, 40, seed=k + bits)
    a, b = _minwise_params(k, seed=k * bits)
    want = minhash_pack_pallas(jnp.asarray(idx), jnp.asarray(nnz),
                               jnp.asarray(a), jnp.asarray(b), bits=bits,
                               interpret=True)
    ops.reset_counts()
    got = ops.minhash_packed(torch.from_numpy(idx), torch.from_numpy(nnz),
                             words_to_int32(a), words_to_int32(b), bits)
    assert ops.counts()["minhash_pack_plain"] == 1
    assert np.array_equal(
        fused_encode.minhash_pack(torch.from_numpy(idx),
                                  torch.from_numpy(nnz), words_to_int32(a),
                                  words_to_int32(b), bits=bits).numpy(),
        np.asarray(want))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("bits", B_FUSED)
@pytest.mark.parametrize("densify", [True, False])
def test_oph_pack_plain_matches_pallas(k, bits, densify):
    idx, nnz = _rows(5, 40, seed=k + bits + densify)
    fam = JOPHHash.make(k, seed=k + bits)
    ja, jb = fam.params()
    want_p, want_e = oph_pack_pallas(jnp.asarray(idx), jnp.asarray(nnz),
                                     ja, jb, k=k, bits=bits, densify=densify,
                                     interpret=True)
    got_p, got_e = fused_encode.oph_pack(
        torch.from_numpy(idx), torch.from_numpy(nnz),
        words_to_int32([fam.a]), words_to_int32([fam.b]), k=k, bits=bits,
        densify=densify)
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert np.array_equal(got_e.numpy(), np.asarray(want_e))


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
@pytest.mark.parametrize("bits", B_FUSED)
def test_encode_packed_k256_matches_reference_host_encode(scheme, bits):
    idx, nnz = _rows(4, 300, seed=bits, zero_row=scheme == "oph_zero")
    got_p, got_e = t_make_scheme(scheme, 256, 5).encode_packed(
        torch.from_numpy(idx), torch.from_numpy(nnz), bits)
    want_p, want_e = j_make_scheme(scheme, 256, 5).encode_packed_numpy(
        idx, nnz, bits)
    assert np.array_equal(got_p.numpy(), want_p)
    assert (got_e is None) == (want_e is None)
    if want_e is not None:
        assert np.array_equal(got_e.numpy(), want_e)


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
def test_unfused_arm_outside_eligibility(scheme):
    """b = 6 straddles bytes: no kernel; the plain torch version runs
    instead, on the operation's plain counter, with the reference's
    bytes."""
    idx, nnz = _rows(4, 50, seed=6, zero_row=scheme == "oph_zero")
    ops.reset_counts()
    got_p, got_e = t_make_scheme(scheme, 32, 2).encode_packed(
        torch.from_numpy(idx), torch.from_numpy(nnz), 6)
    want_p, want_e = j_make_scheme(scheme, 32, 2).encode_packed_numpy(
        idx, nnz, 6)
    counts = ops.counts()
    used, unused = (("minhash_pack", "oph_pack") if scheme == "minwise"
                    else ("oph_pack", "minhash_pack"))
    assert counts[f"{used}_plain"] == 1 and counts[f"{unused}_plain"] == 0
    assert counts[used] == counts[unused] == 0
    assert np.array_equal(got_p.numpy(), want_p)
    if want_e is not None:
        assert np.array_equal(got_e.numpy(), want_e)


def test_wrappers_reject_straddling_b_and_bad_k():
    """B2 packs whole bytes only (b = 6 straddles them); B1 packs at any b
    in [1, 16] and rejects b = 17; an OPH k must be a power of two."""
    idx, nnz = _rows(2, 8, seed=0)
    a, b = _minwise_params(4, 0)
    with pytest.raises(ValueError):
        fused_encode.minhash_pack(torch.from_numpy(idx),
                                  torch.from_numpy(nnz), words_to_int32(a),
                                  words_to_int32(b), bits=17)
    with pytest.raises(ValueError):
        fused_encode.oph_pack(torch.from_numpy(idx), torch.from_numpy(nnz),
                              words_to_int32(a[:1]), words_to_int32(b[:1]),
                              k=8, bits=6)
    with pytest.raises(ValueError):
        fused_encode.oph_pack(torch.from_numpy(idx), torch.from_numpy(nnz),
                              words_to_int32(a[:1]), words_to_int32(b[:1]),
                              k=12, bits=4)


def test_wrappers_refuse_devices_without_a_kernel():
    idx = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fused_encode.minhash_pack(idx, idx[:, 0], idx[0], idx[0], bits=4)


@pytest.mark.parametrize("in_checkout", [True, False])
def test_build_dir_is_under_the_checkout_or_raises(tmp_path, monkeypatch,
                                                   in_checkout):
    from repro_torch.kernels import _build
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setattr(_build, "PACKAGE", pkg.resolve())
    if in_checkout:
        (tmp_path / "pyproject.toml").write_text("")
        assert _build.build_dir() == (tmp_path.resolve() / "build"
                                      / "repro_torch_kernels")
    else:
        with pytest.raises(RuntimeError, match="not in a checkout"):
            _build.build_dir()
