"""The launch shapes that the B1, B2, B5 and B6 wrappers choose on the
CPU.

``oph_pack`` (B2) runs a block of up to 1,024 threads a row that loads
every id of a pass before any hash, 16 bytes at a time where the rows
start aligned (``oph_pack_layout``, ``oph_pack_vec``).
``bbit_linear_packed_fwd`` (B5) gives each row a warp and each lane 8
codes, one load where the rows start aligned, and blocks of 1-8 rows
(``packed_fwd_layout``, ``packed_fwd_vec``).  ``minhash_pack`` (B1) cuts
each row into blocks of a few hash lanes, 1-8 a thread, whose threads
split the row's ids (``minhash_pack_layout``), whole bytes of codes at
any b in [1, 16].
``bbit_linear_packed_bwd_dw`` (B6) gives a block 8 bins and a span of
32-row groups, a cluster of blocks along the rows, chosen from the shapes
alone (``packed_dw_layout``).  The kernels run only on the card
(tests/test_torch_kernels_cuda.py); these are pure functions of shapes
and addresses, checked here.  Nothing here imports JAX or launches."""
import inspect

import numpy as np
import pytest

from repro_torch.core.bbit import pack_codes
from repro_torch.kernels import bbit_linear as bl
from repro_torch.kernels import fused_encode as fe


@pytest.mark.parametrize("k", [2, 8, 256, 1024, 16384])
@pytest.mark.parametrize("m", [1, 50, 2048, 4099, 8192, 65536])
def test_oph_pack_layout_covers_the_row_in_its_passes(m, k):
    threads = fe.oph_pack_layout(m, k)
    assert threads & (threads - 1) == 0
    assert fe.OPH_PACK_MIN_THREADS <= threads <= fe.OPH_PACK_MAX_THREADS
    assert threads % 32 == 0
    ids = fe.OPH_PACK_IDS_PER_THREAD * fe.OPH_PACK_PASSES
    # every id of the padded row in OPH_PACK_PASSES passes, and a thread a
    # bin, unless the block is at its largest
    assert threads * ids >= m or threads == fe.OPH_PACK_MAX_THREADS
    assert threads >= k or threads == fe.OPH_PACK_MAX_THREADS
    # the fewest threads that do so
    half = threads // 2
    assert (threads == fe.OPH_PACK_MIN_THREADS
            or half * ids < m or half < k)


def test_oph_pack_layout_at_the_engine_lanes():
    """k=256: 256 threads at the 2,048 lane (a thread a bin), 512 at the
    8,192 lane (two passes of 8 ids)."""
    assert fe.oph_pack_layout(2048, 256) == 256
    assert fe.oph_pack_layout(8192, 256) == 512


@pytest.mark.parametrize("m,ptr,vec", [
    (2048, 0, True), (8192, 1 << 20, True), (2048, 4, False),
    (2048, 8, False), (4099, 0, False), (4098, 16, False), (4, 32, True),
    (3, 0, False), (1, 16, False),
])
def test_oph_pack_vec(m, ptr, vec):
    """int4 id loads only where every row starts 16-byte aligned."""
    assert fe.oph_pack_vec(m, ptr) is vec


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("n", [0, 1, 64, 1024, 16000, 1 << 20])
def test_packed_fwd_layout_spreads_few_rows(n, sms):
    rows = bl.packed_fwd_layout(n, sms)
    assert rows & (rows - 1) == 0 and 1 <= rows <= bl.PACKED_FWD_MAX_ROWS
    blocks = -(-n // rows)
    assert (blocks <= sms * bl.PACKED_FWD_BLOCKS_PER_SM
            or rows == bl.PACKED_FWD_MAX_ROWS)
    # the fewest rows a block that keep the grid within its budget
    assert rows == 1 or -(-n // (rows // 2)) > sms * bl.PACKED_FWD_BLOCKS_PER_SM


def test_packed_fwd_layout_at_the_engine_buckets():
    """Serving's 1 and 64 rows on a 132-SM card: a warp a block, so 64
    rows run on 64 SMs."""
    assert bl.packed_fwd_layout(1, 132) == 1
    assert bl.packed_fwd_layout(64, 132) == 1


@pytest.mark.parametrize("bits,p_w,ptr,vec", [
    (8, 256, 0, True), (8, 256, 4, False), (8, 36, 0, False),
    (8, 40, 8, True), (4, 32, 2, False), (4, 32, 4, True), (4, 13, 0, False),
    (2, 150, 0, True), (2, 150, 1, False), (1, 5, 3, True), (1, 1, 7, True),
])
def test_packed_fwd_vec(bits, p_w, ptr, vec):
    """A lane's 8 codes are ``bits`` bytes: one load where every row
    starts aligned to that many bytes."""
    assert bl.packed_fwd_vec(bits, p_w, ptr) is vec


# ---------------------------------------------------------------------------
# B1 (minhash_pack) and B6 (bbit_linear_packed_bwd_dw).  The kernels run
# only on the card; these models walk the indices the way their loops in
# csrc/fused_encode.cu and csrc/bbit_linear.cu do.
# ---------------------------------------------------------------------------
def _b1_groups_a_pass(lpt):
    """csrc U: the 4-id groups a thread of ``lpt`` hash lanes loads in a
    pass."""
    return 4 if lpt <= 2 else (2 if lpt == 4 else 1)


def _b1_groups_taken(length, lpt, lt, warps):
    """The 4-id groups of a row of ``length`` ids that a block of B1's
    loops hashes, one entry per (id slice, visit): id slice s (of warps ·
    32 / lt) takes s, s + slices, ... in passes of U groups."""
    groups = -(-max(length, 0) // 4)
    slices = warps * (32 // lt)
    u_max = _b1_groups_a_pass(lpt)
    taken = []
    for s in range(slices):
        for g0 in range(s, groups, slices * u_max):
            taken += [g for u in range(u_max)
                      if (g := g0 + u * slices) < groups]
    return taken


@pytest.mark.parametrize("bits", [1, 2, 8])
@pytest.mark.parametrize("k", [8, 37, 256, 500, 1000])
@pytest.mark.parametrize("n,m", [(1, 2048), (1, 8192), (64, 2048),
                                 (64, 8192), (64, 4099), (1024, 9000)])
def test_minhash_pack_layout_hashes_every_id_and_lane_once(n, m, k, bits):
    """Every id of a row (nnz 0, 1, a partial group, the lane) in exactly
    one id slice of a block, every hash lane of the row in exactly one
    thread of one block, and a block's lanes whole bytes of codes."""
    lpt, lt, warps = fe.minhash_pack_layout(n, k, bits, 132)
    assert lpt in (1, 2, 4, 8) and lt & (lt - 1) == 0 and 1 <= lt <= 32
    assert (fe.MINHASH_PACK_MIN_WARPS <= warps
            <= fe.MINHASH_PACK_MAX_WARPS)
    lanes = lpt * lt
    assert lanes * bits % 8 == 0
    for length in (0, 1, 5, m // 3, m):
        taken = _b1_groups_taken(length, lpt, lt, warps)
        assert sorted(taken) == list(range(-(-length // 4)))
    owned = [j for block in range(-(-k // lanes))
             for t in range(lt) for l in range(lpt)
             if (j := block * lanes + t * lpt + l) < k]
    assert owned == list(range(k))


def _b1_pack_model(codes, k, bits, lanes):
    """csrc's packing loop of B1, block by block: byte q of block y holds
    bits [8q, 8q + 8) of the block's LSB-first stream, code l from
    8q / b while l·b < 8q + 8, lanes >= k as 0; → (packed row bytes,
    times each byte was written)."""
    out_w = (k * bits + 7) // 8
    row = np.zeros(out_w, np.int64)
    writes = np.zeros(out_w, np.int64)
    bytes_ = lanes * bits // 8
    for y in range(-(-k // lanes)):
        for q in range(bytes_):
            col = y * bytes_ + q
            if col >= out_w:
                break
            lo = 8 * q
            byte, lane = 0, lo // bits
            while lane * bits < lo + 8:
                if y * lanes + lane >= k:
                    break
                code = int(codes[y * lanes + lane]) & ((1 << bits) - 1)
                shift = lane * bits - lo
                byte |= code << shift if shift >= 0 else code >> -shift
                lane += 1
            row[col] = byte & 0xFF
            writes[col] += 1
    return row.astype(np.uint8), writes


@pytest.mark.parametrize("bits", range(1, 17))
@pytest.mark.parametrize("k", [8, 37, 256, 500])
@pytest.mark.parametrize("n", [1, 64, 1024])
def test_minhash_pack_layout_at_every_b(n, k, bits):
    """B1 at any b in [1, 16]: a block's lanes are a multiple of
    lcm(b, 8) / b (whole bytes of codes that may straddle bytes), every
    hash lane of a row is one thread's, every id one id slice's, and the
    packing loop writes each byte of the row once, with the bytes of
    ``pack_codes``."""
    lpt, lt, warps = fe.minhash_pack_layout(n, k, bits, 132)
    lanes = lpt * lt
    assert lanes % fe.minhash_pack_min_lanes(bits) == 0
    assert lanes * bits % 8 == 0 and lanes <= 256
    assert fe.minhash_pack_min_lanes(bits) == (
        np.lcm(bits, 8) // bits)
    owned = [j for block in range(-(-k // lanes))
             for t in range(lt) for l in range(lpt)
             if (j := block * lanes + t * lpt + l) < k]
    assert owned == list(range(k))
    for length in (0, 1, 5, 301):
        taken = _b1_groups_taken(length, lpt, lt, warps)
        assert sorted(taken) == list(range(-(-length // 4)))
    rng = np.random.default_rng(bits * 1000 + k)
    codes = rng.integers(0, 1 << bits, size=(1, k)).astype(np.uint16)
    row, writes = _b1_pack_model(codes[0], k, bits, lanes)
    assert np.all(writes == 1)
    assert np.array_equal(row, pack_codes(codes, bits)[0])


def test_minhash_pack_min_lanes():
    """8 lanes (3 bytes) at b=3, 4 (3 bytes) at b=6, 2 (3 bytes) at b=12,
    1 (2 bytes) at b=16; the whole-byte b keep their 8 / b."""
    got = {b: fe.minhash_pack_min_lanes(b) for b in (1, 2, 3, 4, 6, 8, 12,
                                                     16)}
    assert got == {1: 8, 2: 4, 3: 8, 4: 2, 6: 4, 8: 1, 12: 2, 16: 1}


@pytest.mark.parametrize("sms", [66, 114, 132])
@pytest.mark.parametrize("n", [1, 64, 1024])
def test_minhash_pack_layout_spreads_rows_over_the_card(n, sms):
    """k=256, b=8: the fewest lanes a block that keep the grid within its
    budget, so one row is cut into 256 one-lane blocks and 64 rows fill
    every SM."""
    k = 256
    lpt, lt, warps = fe.minhash_pack_layout(n, k, 8, sms)
    lanes = lpt * lt
    blocks = n * -(-k // lanes)
    assert blocks <= sms * fe.MINHASH_PACK_BLOCKS_PER_SM or lanes == 256
    assert lanes == 1 or (n * -(-k // (lanes // 2))
                          > sms * fe.MINHASH_PACK_BLOCKS_PER_SM)
    assert lpt == min(lanes, fe.MINHASH_PACK_MAX_LANES_PER_THREAD)
    assert (blocks * warps >= fe.MINHASH_PACK_WARPS_A_GRID
            or warps == fe.MINHASH_PACK_MAX_WARPS)
    if n == 1:
        assert (lpt, lt, blocks) == (1, 1, 256)
    if n == 64:
        assert blocks >= sms


def test_minhash_pack_layout_at_the_engine_buckets():
    """On a 132-SM card: one row in 256 blocks of one lane and 8 warps; 64
    rows in 1,024 blocks of 16 lanes (2 threads of 8) and 4 warps."""
    assert fe.minhash_pack_layout(1, 256, 8, 132) == (1, 1, 8)
    assert fe.minhash_pack_layout(64, 256, 8, 132) == (8, 2, 4)


def _b6_rows_owned(n, warps, parts):
    """The rows B6's blocks of one bin group add, one entry per (rank,
    warp, lane, step) visit: rank r takes G // parts 32-row groups, one
    more while r < G % parts; warp w of it groups lo + w, lo + w + warps,
    ...; lane 4e + q of a group its rows 4i + q, i = 0 .. 7."""
    groups = -(-n // 32)
    rows = []
    for rank in range(parts):
        lo = groups // parts * rank + min(rank, groups % parts)
        hi = lo + groups // parts + (rank < groups % parts)
        for w in range(warps):
            for g in range(lo + w, hi, warps):
                rows += [row for i in range(8) for q in range(4)
                         if (row := 32 * g + 4 * i + q) < n]
    return rows


@pytest.mark.parametrize("k", [1, 8, 37, 256, 500])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 1024, 4097, 16000])
def test_packed_dw_layout_owns_every_bin_and_row_once(n, k):
    """Every bin in one block of 8, every row in one 32-row group of one
    warp of one block of the cluster, and within the group in one lane's
    steps."""
    warps, parts = bl.packed_dw_layout(n)
    assert 1 <= warps <= bl.PACKED_DW_WARPS
    assert parts & (parts - 1) == 0 and 1 <= parts <= bl.PACKED_DW_MAX_PARTS
    assert sorted(_b6_rows_owned(n, warps, parts)) == list(range(n))
    bins = [j for x in range(-(-k // bl.PACKED_DW_BINS))
            for j in range(x * bl.PACKED_DW_BINS, (x + 1) * bl.PACKED_DW_BINS)
            if j < k]
    assert bins == list(range(k))


@pytest.mark.parametrize("n,warps,parts", [(1, 1, 1), (31, 1, 1), (64, 1, 2),
                                           (200, 2, 4), (1024, 4, 8),
                                           (4097, 4, 8), (16000, 4, 8)])
def test_packed_dw_layout_fills_the_card_from_the_shapes(n, warps, parts):
    """At k=256, 32 bin groups a cluster of ``parts`` blocks: 256 blocks of
    4 warps from the stream batch (1,024 rows) on.  The choice takes the
    row count alone and no card property, so the same shapes sum in the
    same order everywhere."""
    assert bl.packed_dw_layout(n) == (warps, parts)
    if n >= 1024:
        assert -(-256 // bl.PACKED_DW_BINS) * parts >= 2 * 128
    assert list(inspect.signature(bl.packed_dw_layout).parameters) == ["n"]
