"""Sequence- and pipeline-parallel primitives (ROADMAP A6c), held to the
single-device math that the reference's own tests write down
(tests/test_distributed.py::test_sequence_parallel_primitives and
::test_pipeline_parallel_gpipe, which fail on this jax: C1).

One gang of 4 processes over gloo (started once for the file) runs:

  * ``merge_partial_attention``: softmax attention over 32 keys split 4
    ways, one shard fully masked in a second case;
  * ``seq_parallel_ssm_scan``: the incoming state of each of 4 shards of
    h' = A·h + B;
  * ``pipelined_apply``: 4 stages of tanh(x @ W_i) over 6 microbatches,
    its output and each stage's gradient of sum(out²) (a loss held on
    every rank and counted once) against plain autograd through the
    composition.

Each within 1e-5.  The same functions without a group (one shard) are
checked in this process.
"""
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.distributed import (merge_partial_attention,
                                     pipelined_apply, seq_parallel_ssm_scan)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GANG = r"""
import pickle, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, world, port, out_path):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    from repro_torch.distributed import (merge_partial_attention,
                                         pipelined_apply,
                                         seq_parallel_ssm_scan)
    g = dist.new_group(list(range(world)))
    out = {}
    scores = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 32)).astype("f"))
    V = torch.from_numpy(np.random.default_rng(3).normal(
        size=(32, 5)).astype("f"))
    for masked in (False, True):
        s = scores[:, rank * 8:(rank + 1) * 8].clone()
        if masked and rank == 2:
            s[:] = -float("inf")
        lm = s.max(-1).values
        le = torch.where(torch.isfinite(lm)[:, None],
                         torch.exp(s - lm[:, None]), torch.zeros_like(s))
        out[f"attn_{masked}"] = merge_partial_attention(
            lm, le.sum(-1), le @ V[rank * 8:(rank + 1) * 8], g).numpy()
    A = torch.from_numpy(np.random.default_rng(4).uniform(
        .5, .99, (4, 3)).astype("f"))
    B = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 3)).astype("f"))
    out["scan"] = seq_parallel_ssm_scan(A[rank], B[rank], torch.ones(3), g,
                                        rank).numpy()
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(6, 2, 8)).astype("f"))
    W = torch.from_numpy(np.random.default_rng(7).normal(
        size=(4, 8, 8)).astype("f")) * 0.3
    w = W[rank:rank + 1].clone().requires_grad_(True)
    y = pipelined_apply(lambda p, h: torch.tanh(h @ p[0]), (w,), x, g)
    (y ** 2).sum().backward()
    out["pipe_out"] = y.detach().numpy()
    out["pipe_grad"] = w.grad[0].numpy()
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run, args=(4, int(sys.argv[1]), sys.argv[2]), nprocs=4)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("primitives")
    script, out = d / "gang.py", d / "out.pkl"
    script.write_text(textwrap.dedent(GANG))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(_free_port()),
                           str(out)], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _scores():
    s = np.random.default_rng(2).normal(size=(2, 32)).astype("f")
    v = np.random.default_rng(3).normal(size=(32, 5)).astype("f")
    return s, v


def _softmax_attn(s, v):
    e = np.exp(s - s.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)) @ v


@pytest.mark.parametrize("masked", [False, True])
def test_merge_partial_attention_is_exact(gang, masked):
    s, v = _scores()
    if masked:                       # rank 2's keys are all masked
        keep = np.r_[0:16, 24:32]
        want = _softmax_attn(s[:, keep], v[keep])
    else:
        want = _softmax_attn(s, v)
    for r in range(4):
        assert np.abs(gang[r][f"attn_{masked}"] - want).max() < 1e-5


def test_seq_parallel_ssm_scan_gives_each_shard_its_state(gang):
    a = np.random.default_rng(4).uniform(.5, .99, (4, 3)).astype("f")
    b = np.random.default_rng(5).normal(size=(4, 3)).astype("f")
    h = np.ones(3, "f")
    for r in range(4):
        assert np.abs(gang[r]["scan"] - h).max() < 1e-5
        h = a[r] * h + b[r]


def _pipeline_inputs():
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(6, 2, 8)).astype("f"))
    w = torch.from_numpy(np.random.default_rng(7).normal(
        size=(4, 8, 8)).astype("f")) * 0.3
    return x, w


def test_pipelined_apply_output_and_gradients(gang):
    x, w = _pipeline_inputs()
    w = w.clone().requires_grad_(True)
    y = x
    for i in range(4):
        y = torch.tanh(y @ w[i])
    (y ** 2).sum().backward()
    for r in range(4):
        assert np.abs(gang[r]["pipe_out"] - y.detach().numpy()).max() < 1e-5
        assert np.abs(gang[r]["pipe_grad"] - w.grad[r].numpy()).max() < 1e-5
        assert np.abs(gang[r]["pipe_grad"]).sum() > 0


def test_primitives_without_a_group_are_one_shard():
    s, v = _scores()
    st, vt = torch.from_numpy(s), torch.from_numpy(v)
    lm = st.max(-1).values
    le = torch.exp(st - lm[:, None])
    got = merge_partial_attention(lm, le.sum(-1), le @ vt, None)
    assert np.abs(got.numpy() - _softmax_attn(s, v)).max() < 1e-5
    h0 = torch.ones(3)
    assert torch.equal(seq_parallel_ssm_scan(torch.ones(3), torch.ones(3),
                                             h0, None, 0), h0)
    x, w = _pipeline_inputs()
    got = pipelined_apply(lambda p, h: torch.tanh(h @ p[0]), (w[:1],), x)
    assert torch.allclose(got, torch.tanh(x @ w[0]), atol=1e-6)
