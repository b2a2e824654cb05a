"""The launch shapes that the B9 and B10 wrappers choose on the CPU.

``vw_sketch`` (B9) picks one of two kernel designs from the shapes
(``vw_layout``): "lanes", a block of G threads a row, each with a
private column of the row's sketch in shared memory, for m up to
``LANES_MAX_M``; "slice", a block a slice of at most ``SLICE_BUCKETS``
buckets, above.  ``hamming_distance`` (B10) picks its load width
(``load_word``) and lanes a row, threads a block and blocks
(``hamming_layout``).  The kernels run only on the card
(tests/test_torch_kernels_cuda.py); these are pure functions of shapes
and addresses, checked here."""
import pytest

from repro_torch.kernels import hamming as hd
from repro_torch.kernels import vw_sketch as vw


@pytest.mark.parametrize("m", [1, 2, 64, 128, 256])
@pytest.mark.parametrize("mx", [1, 128, 512, 3000, 4480])
def test_vw_layout_lanes_fit_shared_memory(m, mx):
    design, g = vw.vw_layout(256, mx, m)
    assert design == vw.LANES
    assert 32 <= g <= vw.LANES_MAX_THREADS and g & (g - 1) == 0
    assert 4 * m * g <= vw.LANES_SMEM_BYTES
    # enough threads for LANES_IDS_PER_THREAD ids each, unless capped
    cap = min(vw.LANES_MAX_THREADS, vw.LANES_SMEM_BYTES // (4 * m))
    assert g * vw.LANES_IDS_PER_THREAD >= mx or g == cap
    assert g == 32 or (g // 2) * vw.LANES_IDS_PER_THREAD < mx


@pytest.mark.parametrize("n", [1, 32, 256, 4096])
@pytest.mark.parametrize("m", [512, 1024, 1 << 14, 1 << 16])
def test_vw_layout_slices_divide_m_and_fill_the_grid(n, m):
    design, mb = vw.vw_layout(n, 512, m)
    assert design == vw.SLICE
    assert mb & (mb - 1) == 0 and m % mb == 0 and 4 <= mb
    assert mb <= vw.SLICE_BUCKETS
    # the widest slice that still gives SLICE_MIN_BLOCKS blocks, or the
    # narrowest allowed
    assert (n * (m // mb) >= vw.SLICE_MIN_BLOCKS
            or mb == min(m, vw.SLICE_MIN_BUCKETS))
    assert (mb == min(m, vw.SLICE_BUCKETS)
            or n * (m // (2 * mb)) < vw.SLICE_MIN_BLOCKS)


def test_vw_layout_threshold():
    assert vw.vw_layout(256, 512, vw.LANES_MAX_M)[0] == vw.LANES
    assert vw.vw_layout(256, 512, 2 * vw.LANES_MAX_M)[0] == vw.SLICE


@pytest.mark.parametrize("w,ptrs,word", [
    (256, (0, 4096), 16), (256, (0, 4097), 1), (256, (0, 4100), 4),
    (1000, (0, 256), 4), (2048, (16, 32), 16), (45, (0, 0), 1),
    (3, (0, 0), 1), (16, (0, 8), 4), (1, (0, 0), 1),
])
def test_hamming_load_word(w, ptrs, word):
    assert hd.load_word(w, *ptrs) == word


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", [0, 1, 3, 4099, 20000, 300000])
@pytest.mark.parametrize("w,word", [
    (w, word) for w in (1, 3, 16, 45, 250, 256, 1000, 2048)
    for word in (1, 4, 16) if w % word == 0])
def test_hamming_layout_covers_every_row_once(sms, n, w, word):
    lanes, reps, threads, blocks = hd.hamming_layout(n, w, word, sms)
    words = w // word
    assert 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
    assert lanes >= min(words, 32) and (lanes == 1 or lanes // 2 < words)
    assert threads % 32 == 0 and 32 <= threads <= 32 * hd.WARPS_PER_BLOCK
    assert reps in (1, 2, 4)
    rows_per_block = threads // 32 * reps * (32 // lanes)
    assert blocks * rows_per_block >= n
    assert (blocks - 1) * rows_per_block < max(n, 1)
    # more row groups a warp only while the warps overflow one wave
    groups = -(-n // (32 // lanes))
    assert reps == 1 or -(-groups // (reps // 2)) > sms * hd.WARPS_PER_SM
