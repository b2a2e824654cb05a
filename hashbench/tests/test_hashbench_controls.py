"""The check against what it must catch, at the rehearsal size on the CPU.

The control (the reference one step below the configuration, in the
program's place) fails a number of each cell, and a run whose timed path
is broken underneath comes out not correct: a fit that returns its start,
a fit on half of the rows, a fitted table altered; an encode that never
writes its output, leaves half of a chunk's rows out, or alters a byte.
The harness's look for a chip is skipped (``run_cell`` on the CPU).
"""
import dataclasses
import time

import pytest
import torch

from hashbench import controls, harness

CPU = torch.device("cpu")
TRON = "tron-bbit-k500-b16"
ENCODES = ("encode-minwise-k500-b16", "encode-oph-k256-b8")


def run(workload):
    cell = harness.load_cell(workload, rehearsal=True)
    return harness.run_cell(cell, 2 ** 31 + 77, 0.2, False, "cpu",
                            time.perf_counter())["result"]


def over(cell, readings):
    limits = cell.check["limits"]
    return [n for n in limits if readings[n] > limits[n]]


@pytest.mark.parametrize("workload", (TRON,) + ENCODES)
def test_a_sound_run_is_correct(workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload", (TRON,) + ENCODES)
def test_the_control_fails_a_number(workload):
    cell = harness.load_cell(workload, rehearsal=True)
    got = dict(controls.READINGS[cell.traffic["loop"]](
        cell, 11, CPU, control=True, faults=False))
    assert not over(cell, got["sound"])
    assert over(cell, got["control"])


def broken_fit(kind):
    from repro_torch.train import linear_trainer
    real = linear_trainer.train_bbit_liblinear

    def fit(x_tr, y_tr, x_te, y_te, cfg, **kw):
        if kind == "half":
            n = x_tr.shape[0] // 2
            return real(x_tr[:n], y_tr[:n], x_te, y_te, cfg, **kw)
        res = real(x_tr, y_tr, x_te, y_te, cfg, **kw)
        table = res.params["table"].clone()
        if kind == "unchanged":
            table.zero_()
        else:
            table.view(-1)[int(x_tr[0, 0])] += 1.0
        return dataclasses.replace(res, params=dict(res.params, table=table))
    return fit


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
def test_a_broken_fit_is_not_correct(monkeypatch, kind):
    from repro_torch.train import linear_trainer
    monkeypatch.setattr(linear_trainer, "train_bbit_liblinear",
                        broken_fit(kind))
    result = run(TRON)
    assert not result["correct"]
    assert result["failed"] == result["attempted"]


def broken_encode(real, kind):
    def encode(indices, nnz, *args, **kw):
        out = real(indices, nnz, *args, **kw)
        packed, rest = (out if isinstance(out, tuple) else (out, None))
        if kind == "unchanged":
            packed = torch.zeros_like(packed)
        elif kind == "half":
            packed = packed.clone()
            packed[indices.shape[0] // 2:] = 0
        else:
            packed = packed.clone()
            packed[:, 0] ^= 1
        return (packed, rest) if isinstance(out, tuple) else packed
    return encode


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("workload,op", [(ENCODES[0], "minhash_packed"),
                                         (ENCODES[1], "oph_packed")])
def test_a_broken_encode_is_not_correct(monkeypatch, workload, op, kind):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, op, broken_encode(getattr(ops, op), kind))
    result = run(workload)
    assert not result["correct"]
    assert result["failed"] > 0
