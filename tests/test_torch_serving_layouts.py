"""The launch shapes that the B2 and B5 wrappers choose on the CPU.

``oph_pack`` (B2) runs a block of up to 1,024 threads a row that loads
every id of a pass before any hash, 16 bytes at a time where the rows
start aligned (``oph_pack_layout``, ``oph_pack_vec``).
``bbit_linear_packed_fwd`` (B5) gives each row a warp and each lane 8
codes, one load where the rows start aligned, and blocks of 1-8 rows
(``packed_fwd_layout``, ``packed_fwd_vec``).  The kernels run only on the card
(tests/test_torch_kernels_cuda.py); these are pure functions of shapes
and addresses, checked here.  Nothing here imports JAX or launches."""
import pytest

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
