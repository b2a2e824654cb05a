"""The generators: the same seed gives the same bytes, the length law's
median, mean and cap, and the chunk limits."""
import numpy as np
import pytest
import torch

from hashbench.gen import sub_seed
from hashbench.gen.codes import class_codes
from hashbench.gen.corpus import (capped_mean, chunk_plan, doc_lengths,
                                  make_corpus)

CPU = torch.device("cpu")
BIG_SEED = 2 ** 31 + 12345


def test_sub_seeds_differ_by_purpose_and_take_any_whole_number():
    assert sub_seed(BIG_SEED, "a") != sub_seed(BIG_SEED, "b")
    assert sub_seed(BIG_SEED, "a") == sub_seed(BIG_SEED, "a")
    assert 0 <= sub_seed(-1, "a") < 2 ** 63
    assert 0 <= sub_seed(2 ** 70, "a") < 2 ** 63


def test_class_codes_repeat_their_bytes_for_a_seed():
    a = class_codes(500, 16, 4, 0.0, 0.3, 0.05, 0, BIG_SEED, CPU)
    b = class_codes(500, 16, 4, 0.0, 0.3, 0.05, 0, BIG_SEED, CPU)
    c = class_codes(500, 16, 4, 0.0, 0.3, 0.05, 0, BIG_SEED + 1, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    codes, y = a
    assert codes.dtype == torch.int32 and codes.shape == (500, 16)
    assert int(codes.min()) >= 0 and int(codes.max()) < 16
    assert set(y.unique().tolist()) == {0, 1}


def test_class_codes_share_their_prototype_at_the_resemblance():
    codes, y = class_codes(20000, 64, 16, 0.5, 0.5, 0.0, 3, 7, CPU)
    # two documents of one class agree where both copied: r^2 = 0.25
    same = (codes[y == 1][:2000] == codes[y == 1][2000:4000]).float().mean()
    assert abs(float(same) - 0.25) < 0.01


def test_corpus_repeats_its_bytes_for_a_seed():
    cfg = {"n_docs": 300, "nnz_median": 30, "nnz_mean": 60, "nnz_cap": 512,
           "ambient_dim": 1 << 30, "instance_seed": 0}
    traffic = {"chunk_max_rows": 64, "chunk_max_slots": 8192,
               "width_multiple": 16}
    p1, c1 = make_corpus(cfg, traffic, BIG_SEED, CPU)
    p2, c2 = make_corpus(cfg, traffic, BIG_SEED, CPU)
    assert p1 == p2
    for (i1, n1), (i2, n2) in zip(c1, c2):
        assert torch.equal(i1, i2) and torch.equal(n1, n2)
        assert i1.dtype == n1.dtype == torch.int32
        assert int(i1.min()) >= 0 and int(i1.max()) < 1 << 30
    # another seed: the instance's lengths and chunks, other ids
    p3, c3 = make_corpus(cfg, traffic, BIG_SEED + 1, CPU)
    assert p3 == p1
    assert all(torch.equal(n1, n3) for (_, n1), (_, n3) in zip(c1, c3))
    assert not torch.equal(c1[0][0], c3[0][0])


def test_length_law_median_mean_and_cap():
    median, mean, cap = 3051, 12062, 1 << 18
    lens = doc_lengths(677399, median, mean, cap, BIG_SEED, CPU).numpy()
    assert np.all(np.diff(lens) >= 0)
    assert lens.min() >= 1 and lens.max() == cap
    assert abs(np.median(lens) / median - 1) < 0.01
    expect = capped_mean(median, mean, cap)
    assert 11000 < expect < 11400          # Table 1's 12,062 less the cap
    assert abs(lens.mean() / expect - 1) < 0.02
    assert 0.002 < np.mean(lens == cap) < 0.005


def test_chunk_plan_keeps_every_limit_and_every_row():
    lens = np.sort(doc_lengths(50000, 3051, 12062, 1 << 18, 3, CPU).numpy())
    plan = chunk_plan(lens, 65536, 1 << 28, 128)
    assert plan[0].start == 0
    assert sum(c.rows for c in plan) == lens.size
    for c, nxt in zip(plan, plan[1:] + [None]):
        assert 1 <= c.rows <= 65536
        assert c.rows * c.width <= 1 << 28
        assert c.width % 128 == 0
        assert c.width >= lens[c.start + c.rows - 1]
        if nxt is not None:
            assert nxt.start == c.start + c.rows
            # greedy: one more row would break a limit
            more = -(-lens[c.start + c.rows] // 128) * 128
            assert (c.rows + 1 > 65536
                    or (c.rows + 1) * max(more, c.width) > 1 << 28)


def test_chunk_plan_refuses_a_row_past_the_slots():
    with pytest.raises(ValueError):
        chunk_plan(np.array([5, 300]), 64, 256, 16)


@pytest.mark.parametrize("instance", (0, 3))
def test_training_set_is_the_instance_and_the_test_set_the_seeds(instance):
    from hashbench.loops.fit_loop import make_inputs
    cfg = {"n_docs": 500, "train_docs": 400, "k": 16, "b": 4,
           "resemblance_low": 0.0, "resemblance_high": 0.5,
           "label_flip": 0.05}
    a = make_inputs(cfg, BIG_SEED, CPU, instance)
    b = make_inputs(cfg, 5, CPU, instance)
    assert torch.equal(a.x_tr, b.x_tr) and torch.equal(a.y_tr, b.y_tr)
    assert a.x_te.shape == (100, 16) and not torch.equal(a.x_te, b.x_te)
    # one law: test documents share the training documents' prototypes
    same = lambda x, y: (x[:, None, :] == y[None, :, :]).float().mean()
    assert same(a.x_te[a.y_te == 1][:50], a.x_tr[a.y_tr == 1][:50]) > 1.5 / 16
    # another instance: other training documents, other test documents
    c = make_inputs(cfg, BIG_SEED, CPU, instance + 1)
    assert not torch.equal(a.x_tr, c.x_tr)
    assert not torch.equal(a.x_te, c.x_te)


def test_the_window_fits_every_instance_in_whole_cycles(monkeypatch):
    import contextlib
    from types import SimpleNamespace
    from hashbench.loops import fit_loop
    state = SimpleNamespace(data=[None] * 3)
    calls = []

    def fake_fit(state, i, max_iter=None):
        calls.append(i)
        return SimpleNamespace(n_iter=i, train_acc=1.0, test_acc=0.5)
    monkeypatch.setattr(fit_loop, "run_fit", fake_fit)
    win = fit_loop.window(state, 0.0, lambda name: contextlib.nullcontext())
    assert calls == [0, 1, 2] and win.calls == 3
    assert win.values["instance"] == [0, 1, 2]


def test_the_encode_check_samples_every_chunk_at_both_ends():
    from types import SimpleNamespace
    from hashbench.gen.corpus import Chunk
    from hashbench.loops.encode_passes import sample_rows
    plan = [Chunk(0, 64, 16), Chunk(64, 3, 32), Chunk(67, 40, 48)]
    state = SimpleNamespace(plan=plan, seed=BIG_SEED,
                            cell=SimpleNamespace(check={"rows_per_chunk": 5}))
    rows = sample_rows(state)
    assert np.array_equal(rows, sample_rows(state))
    for c in plan:
        mine = rows[(rows >= c.start) & (rows < c.start + c.rows)]
        assert {c.start, c.start + c.rows - 1} <= set(mine.tolist())
        assert len(mine) >= min(c.rows, 5)
