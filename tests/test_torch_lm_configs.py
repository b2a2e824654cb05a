"""The LM zoo's configs and synthetic token streams in the port against
the reference (ROADMAP A6a): the ten registered architectures field for
field, their parameter counts, ``ALL_ARCHS``, ``reduced_config``, the
registry's lookups, and ``lm_synth``'s batches byte for byte."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs import archs as j_archs
from repro.configs import base as j_base
from repro.data import lm_synth as j_synth
from repro.launch.smoke_configs import reduced_config as j_reduced

from repro_torch.configs import (ArchConfig, archs, get_config,
                                 list_configs, register)
from repro_torch.data import lm_example_stream, lm_synth, token_batch
from repro_torch.launch.smoke_configs import reduced_config

ARCHS = j_archs.ALL_ARCHS


def test_all_archs_and_registry_match_reference():
    assert archs.ALL_ARCHS == j_archs.ALL_ARCHS
    assert sorted(list_configs()) == sorted(j_base.list_configs())
    assert set(archs.ALL_ARCHS) <= set(list_configs())
    assert [f.name for f in dataclasses.fields(ArchConfig)] == [
        f.name for f in dataclasses.fields(j_base.ArchConfig)]
    with pytest.raises(KeyError) as got:
        get_config("no-such-arch")
    with pytest.raises(KeyError) as want:
        j_base.get_config("no-such-arch")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch):
    cfg, ref = get_config(arch), j_base.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.head_dim, cfg.is_moe, cfg.is_encdec) == (
        ref.head_dim, ref.is_moe, ref.is_encdec)
    for variant in ({}, {"embedding": "bbit_hash"}):
        c = dataclasses.replace(cfg, **variant)
        r = dataclasses.replace(ref, **variant)
        assert c.n_params() == r.n_params()
        assert c.n_active_params() == r.n_active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_matches_reference(arch):
    assert dataclasses.asdict(reduced_config(get_config(arch))) == \
        dataclasses.asdict(j_reduced(j_base.get_config(arch)))


def test_register_adds_a_config():
    from repro_torch.configs.base import _REGISTRY
    cfg = dataclasses.replace(get_config("yi-9b"), name="yi-9b-test-copy")
    try:
        assert register(cfg) is cfg
        assert get_config("yi-9b-test-copy") is cfg
        assert list_configs()["yi-9b-test-copy"] is cfg
    finally:
        _REGISTRY.pop("yi-9b-test-copy", None)
    assert "yi-9b-test-copy" not in list_configs()


@pytest.mark.parametrize("batch,seq,vocab,seed,zipf_a", [
    (2, 16, 512, 0, 1.2), (3, 33, 92544, 7, 1.2), (1, 5, 3, 1, 1.5),
    (4, 64, 8192, 123, 1.05)])
def test_token_batch_bytes_match_reference(batch, seq, vocab, seed, zipf_a):
    got = token_batch(batch, seq, vocab, seed=seed, zipf_a=zipf_a)
    want = j_synth.token_batch(batch, seq, vocab, seed=seed, zipf_a=zipf_a)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


def test_lm_example_stream_matches_reference():
    got = itertools.islice(lm_example_stream(2, 32, 512, seed=5), 4)
    want = itertools.islice(j_synth.lm_example_stream(2, 32, 512, seed=5), 4)
    for (s1, t1, y1), (s2, t2, y2) in zip(got, want):
        assert s1 == s2
        assert t1.tobytes() == t2.tobytes() and y1.tobytes() == y2.tobytes()
        assert np.array_equal(t1[:, 1:], y1[:, :-1])
    assert lm_synth.token_batch is token_batch
