"""The port's LIBSVM I/O, sharded loaders and archive fsck against the
reference's: LIBSVM files byte for byte in both directions, loader
batches equal for every (seed, epoch, shard, backup) and ``start_step``,
and ``launch/fsck.py`` giving the reference's report, quarantine and
exit codes on archives written by either package, torn ones included."""
import io
import os
import shutil

import numpy as np
import pytest

from repro.data import libsvm_io as jio
from repro.data.loader import HashedCodesLoader as JHashedCodesLoader
from repro.data.loader import SparseRowsLoader as JSparseRowsLoader
from repro.launch import fsck as jfsck

from repro_torch.data import libsvm_io as tio
from repro_torch.data.loader import HashedCodesLoader, SparseRowsLoader
from repro_torch.launch import fsck as tfsck


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = [np.sort(rng.choice(1 << 30, size=int(s), replace=False))
            for s in rng.integers(0, 40, size=n)]
    labels = rng.integers(0, 2, size=n)
    return rows, labels


# ---------------------------------------------------------------------------
# LIBSVM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True])
def test_libsvm_files_byte_equal_both_ways(tmp_path, weighted):
    rows, labels = _rows(25, seed=weighted)
    rng = np.random.default_rng(3)
    vals = ([rng.normal(size=len(r)).astype(np.float32) for r in rows]
            if weighted else None)
    mine, theirs = str(tmp_path / "t.libsvm"), str(tmp_path / "j.libsvm")
    assert tio.write_libsvm(mine, rows, labels, values=vals) == 25
    assert jio.write_libsvm(theirs, rows, labels, values=vals) == 25
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    # each package reads the other's file to the same arrays
    for reader, path in ((tio.read_libsvm, theirs), (jio.read_libsvm, mine)):
        got = list(reader(path, with_values=weighted))
        want = list(jio.read_libsvm(theirs, with_values=weighted))
        assert len(got) == len(want) == 25
        for (gi, gy, gv), (wi, wy, wv) in zip(got, want):
            assert gy == wy and np.array_equal(gi, wi)
            assert gi.dtype == wi.dtype == np.int64
            assert (gv is None) == (wv is None)
            if gv is not None:
                assert np.array_equal(gv, wv)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_libsvm_shards_byte_equal(tmp_path, n_shards):
    rows, labels = _rows(31, seed=n_shards)
    mine = tio.write_shards(str(tmp_path / "t"), rows, labels, n_shards)
    theirs = jio.write_shards(str(tmp_path / "j"), rows, labels, n_shards)
    assert [os.path.basename(p) for p in mine] == [
        os.path.basename(p) for p in theirs]
    for p, q in zip(mine, theirs):
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read()
    got_rows, got_y = tio.read_shards(theirs)
    want_rows, want_y = jio.read_shards(mine)
    assert np.array_equal(got_y, want_y) and got_y.dtype == np.int32
    assert all(np.array_equal(a, b) for a, b in zip(got_rows, want_rows))
    assert tio.shard_paths("r", 2) == jio.shard_paths("r", 2)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------
def _codes(n=203, k=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 16, size=(n, k)).astype(np.uint16),
            rng.integers(0, 2, size=n).astype(np.int32))


def _same(got, want):
    assert len(got) == len(want)
    for (gs, gc, gy), (ws, wc, wy) in zip(got, want):
        assert gs == ws
        assert np.array_equal(gc, wc) and np.array_equal(gy, wy)


@pytest.mark.parametrize("seed", [0, 3, 12345])
@pytest.mark.parametrize("num_shards,shard_id,backup_of",
                         [(1, 0, None), (2, 1, None), (3, 0, 2),
                          (4, 3, 1)])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_loader_batches_equal_the_reference(seed, num_shards, shard_id,
                                            backup_of, drop_remainder):
    codes, y = _codes(seed=seed)
    kw = dict(seed=seed, shard_id=shard_id, num_shards=num_shards,
              backup_of=backup_of, drop_remainder=drop_remainder)
    mine = HashedCodesLoader(codes, y, 16, **kw)
    theirs = JHashedCodesLoader(codes, y, 16, **kw)
    assert mine.steps_per_epoch() == theirs.steps_per_epoch()
    _same(list(mine.batches(0, epochs=3)), list(theirs.batches(0, epochs=3)))


@pytest.mark.parametrize("start_step", [0, 1, 5, 12, 13, 30])
def test_loader_replays_from_start_step(start_step):
    codes, y = _codes(seed=7)
    full = list(HashedCodesLoader(codes, y, 16, seed=3).batches(0, epochs=3))
    resumed = list(HashedCodesLoader(codes, y, 16, seed=3).batches(
        start_step, epochs=3))
    want = list(JHashedCodesLoader(codes, y, 16, seed=3).batches(
        start_step, epochs=3))
    _same(resumed, want)
    _same(resumed, [b for b in full if b[0] >= start_step])


def test_loader_prefetching_and_errors():
    codes, y = _codes(seed=1)
    loader = HashedCodesLoader(codes, y, 32, seed=5)
    _same(list(loader.prefetching(3, epochs=2, depth=3)),
          list(JHashedCodesLoader(codes, y, 32, seed=5).batches(3,
                                                                epochs=2)))
    with pytest.raises(ValueError):
        HashedCodesLoader(codes, y[:-1], 8)


@pytest.mark.parametrize("start_step", [0, 4])
def test_sparse_rows_loader_equals_the_reference(start_step):
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 1 << 30, size=(90, 12)).astype(np.int32)
    nnz = rng.integers(0, 13, size=90).astype(np.int32)
    y = rng.integers(0, 2, size=90).astype(np.int32)
    kw = dict(seed=9, shard_id=1, num_shards=2)
    got = list(SparseRowsLoader(idx, nnz, y, 8, **kw).batches(start_step,
                                                               epochs=2))
    want = list(JSparseRowsLoader(idx, nnz, y, 8, **kw).batches(start_step,
                                                                 epochs=2))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert all(np.array_equal(a, b) for a, b in zip(g[1:], w[1:]))


# ---------------------------------------------------------------------------
# fsck
# ---------------------------------------------------------------------------
N_SHARDS = 4


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The same corpus hashed by each package into a 4-shard archive
    (minwise, k=32, b=6: B1 at a b whose codes straddle bytes)."""
    from repro.data import preprocess_and_save as j_save
    from repro_torch.data.hashed_dataset import preprocess_and_save
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    rows, labels = generate_arrays(
        120, SynthRcv1Config(seed=2, topic_tokens=60, background_frac=0.3,
                             max_pairs_per_doc=300, max_triples_per_doc=100))
    base = tmp_path_factory.mktemp("fsck")
    preprocess_and_save(str(base / "torch"), rows, labels, k=32, b=6,
                        seed=1, n_shards=N_SHARDS, chunk=64, device="cpu")
    j_save(str(base / "jax"), rows, labels, k=32, b=6, seed=1,
           n_shards=N_SHARDS, chunk=64)
    for name in sorted(os.listdir(base / "jax")):
        if name.endswith(".npy"):
            assert ((base / "torch" / name).read_bytes()
                    == (base / "jax" / name).read_bytes()), name
    return {"torch": str(base / "torch"), "jax": str(base / "jax")}


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _lines(fsck, root, **kw):
    """(report, printed lines with the archive's path taken out)."""
    buf = io.StringIO()
    report = fsck.fsck_archive(root, out=buf, **kw)
    return report, buf.getvalue().replace(root, "<root>")


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_fsck_clean_archive(archives, writer, capsys):
    root = archives[writer]
    assert tfsck.main([root]) == 0
    out = capsys.readouterr().out
    assert "CLEAN" in out and f"{N_SHARDS}/{N_SHARDS} shards verified" in out
    report, lines = _lines(tfsck, root)
    assert (report, lines) == _lines(jfsck, root)
    assert report["verified"] == N_SHARDS and not report["corrupt"]


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("victim", ["codes", "labels", "rows"])
def test_fsck_corrupt_and_quarantine(archives, writer, victim, tmp_path,
                                     capsys):
    """A flipped byte deep in shard 3: the same report and exit code as
    the reference's; ``--quarantine`` moves the shard's files aside."""
    mine = _copy(archives[writer], tmp_path / "t")
    theirs = _copy(archives[writer], tmp_path / "j")
    for root in (mine, theirs):
        path = os.path.join(root, f"hashed_00003.{victim}.npy")
        with open(path, "r+b") as f:
            f.seek(-2, os.SEEK_END)
            last = f.read(1)
            f.seek(-2, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
    assert tfsck.main([mine]) == 1
    assert jfsck.main([theirs]) == 1
    got, lines = _lines(tfsck, mine)
    want, jlines = _lines(jfsck, theirs)
    assert lines.replace(mine, "") == jlines.replace(theirs, "")
    assert set(got["corrupt"]) == set(want["corrupt"]) == {3}
    assert victim in got["corrupt"][3]
    assert got["verified"] == want["verified"] == N_SHARDS - 1
    got = tfsck.fsck_archive(mine, quarantine=True)
    want = jfsck.fsck_archive(theirs, quarantine=True)
    assert ([os.path.basename(p) for p in got["quarantined"][3]]
            == [os.path.basename(p) for p in want["quarantined"][3]])
    assert not os.path.exists(os.path.join(mine, "hashed_00003.codes.npy"))
    assert all(os.path.exists(p) for p in got["quarantined"][3])
    # the quarantined shard is now unreadable: reported, still exit 1
    capsys.readouterr()
    assert tfsck.main([mine]) == 1
    assert "shard     3: UNREADABLE" in capsys.readouterr().out


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_fsck_torn_shard(archives, writer, tmp_path, capsys):
    """A shard file cut short (a torn write): the port reports the shard
    unreadable, checks the others and exits 1.  The reference lets
    numpy's ValueError escape (ROADMAP C5), which also ends its CLI with
    status 1."""
    mine = _copy(archives[writer], tmp_path / "t")
    for name in ("codes", "labels"):
        path = os.path.join(mine, f"hashed_00001.{name}.npy")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 5)
        with pytest.raises(ValueError):
            jfsck.fsck_archive(mine, out=io.StringIO())
        assert tfsck.main([mine]) == 1
        assert "shard     1: UNREADABLE" in capsys.readouterr().out
        got = tfsck.fsck_archive(mine, out=io.StringIO())
        assert set(got["corrupt"]) == {1}
        assert got["corrupt"][1].startswith("unreadable")
        assert got["verified"] == N_SHARDS - 1


def test_fsck_not_an_archive_and_unchecked(archives, tmp_path, capsys):
    assert tfsck.main([str(tmp_path / "nothing")]) == 2
    assert "not a hashed archive" in capsys.readouterr().err
    # an archive that predates per-shard checksums: nothing to verify
    old = _copy(archives["torch"], tmp_path / "old")
    import json
    meta_path = os.path.join(old, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta.pop("shard_checksums")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    report, lines = _lines(tfsck, old)
    assert (report, lines) == _lines(jfsck, old)
    assert "nothing to verify" in lines
    assert report["unchecked"] == N_SHARDS and tfsck.main([old]) == 0
