"""Whole passes of the scheme's packed encode over a corpus held on the card.

The corpus (``gen.corpus``) is made at set-up, in length-sorted chunks of
padded int32 rows.  A pass calls ``scheme.encode_packed`` on every chunk
in order, dispatched ahead with no sync inside the pass, and one
``synchronize`` ends it; the warm-up is one whole pass.  The outputs of
the window's last pass are kept, and the check compares a sample of
their rows with the plain reference, byte for byte: in every chunk its
shortest and longest row and a number more drawn from the seed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from hashbench.loops import Window
from hashbench.gen import sub_seed
from hashbench.gen.corpus import make_corpus
from hashbench.reference import hashing as ref

REFERENCE = {"minwise": ref.minwise_packed, "oph": ref.oph_densified_packed}


@dataclasses.dataclass
class State:
    cell: object
    device: torch.device
    seed: int
    hash_seed: int
    plan: list
    chunks: list
    scheme: object
    outs: list = dataclasses.field(default_factory=list)
    phases: dict = dataclasses.field(default_factory=dict)


def hash_seed(seed: int) -> int:
    return sub_seed(seed, "hash") % (1 << 32)


def one_pass(state: State, span) -> List[torch.Tensor]:
    b = state.cell.config["b"]
    outs = []
    for ids, nnz in state.chunks:
        with span("encode_packed"):
            outs.append(state.scheme.encode_packed(ids, nnz, b)[0])
    return outs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cell, seed: int, device: torch.device) -> State:
    from repro_torch.core.schemes import make_scheme
    cfg = cell.config
    t0 = time.perf_counter()
    plan, chunks = make_corpus(cfg, cell.traffic, seed, device)
    _sync(device)
    t1 = time.perf_counter()
    hs = hash_seed(seed)
    state = State(cell, device, seed, hs, plan, chunks,
                  make_scheme(cfg["scheme"], cfg["k"], hs))
    one_pass(state, lambda name: contextlib.nullcontext())   # warm-up
    _sync(device)
    state.phases = {"inputs_s": t1 - t0,
                    "warmup_s": time.perf_counter() - t1,
                    "chunks": len(plan)}
    return state


def window(state: State, seconds: float, span) -> Window:
    passes = 0
    t0 = time.perf_counter()
    while True:
        state.outs = one_pass(state, span)
        _sync(state.device)
        passes += 1
        wall = time.perf_counter() - t0
        if wall >= seconds:
            break
    docs = passes * state.cell.config["n_docs"]
    return Window({"encode_docs_per_s": docs / wall}, passes, docs, wall)


def shapes(state: State) -> dict:
    cfg = state.cell.config
    return {"scheme": cfg["scheme"], "k": cfg["k"], "bits": cfg["b"],
            "chunks": [(c.rows, int(nnz.sum())) for c, (_, nnz)
                       in zip(state.plan, state.chunks)]}


def sample_rows(state: State) -> np.ndarray:
    """Global row indices (length order): in every chunk its shortest and
    its longest row and ``rows_per_chunk`` more drawn from the seed, so
    each chunk's width is compared in every run."""
    rng = np.random.default_rng(sub_seed(state.seed, "check_rows"))
    per = state.cell.check["rows_per_chunk"]
    rows = [c.start + np.concatenate(
        [[0, c.rows - 1], rng.choice(c.rows, min(per, c.rows),
                                     replace=False)])
            for c in state.plan]
    return np.unique(np.concatenate(rows))


def judge(state: State, got=None, want=None) -> Tuple[int, int, int]:
    """(rows of the sample whose bytes differ, rows compared, the fewest
    rows compared in a chunk).  ``got(ci,
    local)`` gives the rows ``local`` of chunk ``ci`` as the program
    produced them (the window's last pass by default); ``want(ids,
    nnz)`` encodes padded rows as the reference does (by default)."""
    cfg = state.cell.config
    if got is None:
        got = lambda ci, local: state.outs[ci][local]
    if want is None:
        fn = REFERENCE[cfg["scheme"]]
        want = lambda ids, nnz: fn(ids, nnz, cfg["k"], cfg["b"],
                                   state.hash_seed)
    rows = sample_rows(state)
    starts = np.array([c.start for c in state.plan])
    which = np.searchsorted(starts, rows, side="right") - 1
    bad = 0
    per_chunk = np.bincount(which, minlength=len(state.plan))
    for ci in np.unique(which):
        local = torch.from_numpy(rows[which == ci] - starts[ci]).to(
            state.device)
        ids, nnz = state.chunks[ci]
        sel_nnz = nnz[local]
        sel_ids = ids[local][:, :int(sel_nnz.max())].contiguous()
        bad += int((got(ci, local) != want(sel_ids, sel_nnz)).any(dim=1)
                   .sum())
    return bad, len(rows), int(per_chunk.min())


def check(state: State) -> Tuple[Dict[str, float], int]:
    bad, rows, fewest = judge(state)
    return {"mismatched_rows": bad, "rows_compared": rows,
            "fewest_rows_in_a_chunk": fewest}, bad
