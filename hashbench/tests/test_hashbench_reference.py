"""The plain reference against a second, independent computation: uint32
NumPy arithmetic for the hashes, hand-worked rows for densification and
packing, autograd for the gradient."""
import numpy as np
import torch

from hashbench.reference import hashing, linear


def np_hash(t, a, b):
    h = (np.uint32(a) * np.asarray(t, np.uint32) + np.uint32(b))
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    return h ^ (h >> np.uint32(16))


def rows(seed=0, n=6, m=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1 << 30, (n, m)).astype(np.int32)
    nnz = rng.integers(1, m + 1, n).astype(np.int32)
    return ids, nnz


def unpack(packed, k, bits):
    b = np.unpackbits(packed, axis=1, bitorder="little")[:, :k * bits]
    return (b.reshape(-1, k, bits) << np.arange(bits)).sum(axis=2)


def test_minwise_codes_match_uint32_arithmetic():
    ids, nnz = rows()
    k, bits, seed = 7, 13, 99
    got = hashing.minwise_packed(torch.from_numpy(ids),
                                 torch.from_numpy(nnz), k, bits, seed,
                                 lanes=3)
    a, b = hashing.minwise_words(k, seed)
    assert np.all(a % 2 == 1)
    want = np.array([[np_hash(ids[i, :nnz[i]], a[j], b[j]).min()
                      & ((1 << bits) - 1) for j in range(k)]
                     for i in range(len(ids))])
    assert np.array_equal(unpack(got.numpy(), k, bits), want)


def test_oph_codes_match_uint32_arithmetic_and_rotation():
    ids, nnz = rows(1, n=40, m=12)
    k, bits, seed = 16, 8, 5
    got = hashing.oph_densified_packed(torch.from_numpy(ids),
                                       torch.from_numpy(nnz), k, bits, seed)
    a, b = hashing.oph_words(seed)
    want = []
    for i in range(len(ids)):
        h = np_hash(ids[i, :nnz[i]], a, b)
        vals = {}
        for x in h:
            j = int(x) >> 28
            vals[j] = min(vals.get(j, 1 << 32), int(x))
        row = []
        for j in range(k):
            d = next(d for d in range(k) if (j + d) % k in vals)
            row.append((vals[(j + d) % k] + d * 0x9E3779B1) & 0xFFFFFFFF)
        want.append([v & 0xFF for v in row])
    assert np.array_equal(got.numpy(), np.array(want, np.uint8))
    assert any(len(set(r)) < k for r in want)     # some bins were empty


def test_pack_is_lsb_first():
    codes = torch.tensor([[1, 2, 3]])
    # 3-bit codes 1, 2, 3 give the bit stream (each code's lowest bit
    # first) 1 0 0 | 0 1 0 | 1 1 0: byte 0 holds bits 1,0,0,0,1,0,1,1
    # from its lowest bit up, byte 1 the last 0
    assert hashing.pack_lsb(codes, 3).tolist() == [[0b11010001, 0]]


def test_gradient_matches_autograd_of_the_objective():
    torch.manual_seed(0)
    k, v, n, C = 5, 8, 50, 0.7
    codes = torch.randint(0, v, (n, k), dtype=torch.int32)
    y = torch.randint(0, 2, (n,), dtype=torch.int32)
    table = torch.randn(k, v, 1, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(1, dtype=torch.float64, requires_grad=True)
    m = linear.signs(y, torch.float64) * (
        table[torch.arange(k), codes.long()].sum(dim=1)[:, 0] + bias)
    f = 0.5 * (table.pow(2).sum() + bias.pow(2).sum()) \
        + C * torch.nn.functional.softplus(-m).sum()
    f.backward()
    gt, gb = linear.gradient(table.detach(), bias.detach(), codes, y, C)
    assert torch.allclose(gt, table.grad)
    assert torch.allclose(gb, bias.grad[0])
    assert abs(linear.objective(table.detach(), bias.detach(), codes, y, C)
               - float(f.detach())) < 1e-9
