"""Coordinated checkpoints of a gang: one payload a rank, one commit
(counterpart of ``repro/ckpt/coordinated.py``, the same layout, so
either package restores the other's steps).

Every rank of a ``procs``-wide run checkpoints at the same shard
boundary (the schedule is global).  The step directory holds one CRC'd
payload a rank and a step ``meta.json`` written by rank 0; the rename
of the stage onto the step and the manifest update commit it:

  <dir>/manifest.json                 shared step index (rank 0 writes)
  <dir>/step_S/rank_00000/ckpt.npz    rank 0's payload
  <dir>/step_S/rank_00000/meta.json   {"rank", "crc32", ...}
  <dir>/step_S/rank_00001/…           rank 1's payload
  <dir>/step_S/meta.json              the commit record: step, gang
                                      size, each rank's CRCs, and the
                                      trainer's extra_meta

``save_coordinated``:

  1. each rank stages its payload under ``<dir>/.stage-s<S>/rank_<r>``:
     a rank-private tmp dir, fsync'd, renamed into the stage;
  2. rank 0 polls until all ``procs`` payloads are there
     (``barrier_timeout_s`` turns a dead rank into an error instead of a
     hang), writes the step meta, fsyncs, renames the stage to
     ``step_S`` and updates the manifest.  A crash before that rename
     (the injected ``manifest_write`` kill included) leaves only a
     ``.stage-*`` directory, which no restore reads;
  3. other ranks return once their payload has landed.  A stage left by
     a gang that died is not deleted up front (it may be a live peer's
     write); a replayed rank's payload replaces its own there, byte for
     byte the same under deterministic replay.

``load_step_arrays`` (reached through ``ckpt.checkpoint.restore``):
the restoring process prefers its own rank's payload; a torn one is
quarantined (moved aside) and any other rank's valid payload used, since
the checkpointed state is replicated.  Only when no payload is valid is
the step corrupt, and the walk falls back to the previous step.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
import zlib
from typing import Any, Optional

import numpy as np

from repro_torch import tree as _tree
from repro_torch.ft import faults

log = logging.getLogger("repro_torch.ckpt")

COORDINATED_FORMAT = 5

__all__ = ["save_coordinated", "load_step_arrays", "is_coordinated_dir",
           "COORDINATED_FORMAT"]


def _rank_name(rank: int) -> str:
    return f"rank_{rank:05d}"


def _stage_dir(root: str, step: int) -> str:
    return os.path.join(root, f".stage-s{step}")


def is_coordinated_dir(step_dir: str) -> bool:
    """A committed coordinated step: rank payloads, no top-level npz."""
    return (not os.path.exists(os.path.join(step_dir, "ckpt.npz"))
            and os.path.isdir(os.path.join(step_dir, _rank_name(0))))


def _write_rank_payload(stage: str, rank: int, step: int,
                        tree: Any) -> None:
    """Stages one rank's CRC'd payload atomically (tmp, fsync, rename).
    An armed ``ckpt_write`` fault tears it as ``checkpoint.save`` does:
    the payload is truncated after the rename, then ``InjectedCrash``."""
    from repro_torch.ckpt.checkpoint import _fsync_path, _host

    leaves = _tree.leaves(tree)
    arrays = {f"leaf_{i:05d}": _host(x) for i, x in enumerate(leaves)}
    directive = (faults.on_ckpt_write(step)
                 if faults._ACTIVE is not None else None)
    tmp = os.path.join(stage, f".tmp-{_rank_name(rank)}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    payload = os.path.join(tmp, "ckpt.npz")
    np.savez(payload, **arrays)
    meta = {"rank": int(rank), "step": int(step),
            "n_leaves": len(leaves),
            "ckpt_format": COORDINATED_FORMAT,
            "crc32": {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                      for k, v in arrays.items()}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if directive == "torn":
        size = os.path.getsize(payload)
        with open(payload, "r+b") as f:
            f.truncate(max(1, int(size * 0.6)))
    else:
        _fsync_path(payload)
    final = os.path.join(stage, _rank_name(rank))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_path(stage)
    if directive == "torn":
        raise faults.InjectedCrash(
            f"injected torn rank-{rank} checkpoint write at step {step}")


def _rank_meta(stage: str, rank: int) -> Optional[dict]:
    try:
        with open(os.path.join(stage, _rank_name(rank),
                               "meta.json")) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None


def save_coordinated(
    root: str,
    step: int,
    tree: Any,
    *,
    rank: int,
    procs: int,
    keep_last: int = 3,
    extra_meta: Optional[dict] = None,
    barrier_timeout_s: float = 120.0,
) -> Optional[str]:
    """One rank's half of a coordinated save; every rank of the gang
    calls it at the same boundary → the committed step dir on rank 0,
    ``None`` on the others (which return once their payload is
    staged)."""
    from repro_torch.ckpt.checkpoint import (_fsync_path, _read_manifest,
                                             _step_dir, _write_manifest)

    os.makedirs(root, exist_ok=True)
    stage = _stage_dir(root, step)
    # no stale-stage cleanup: a visible stage may be another rank's write
    # of this very step; a payload left by a dead gang is replaced below
    os.makedirs(stage, exist_ok=True)
    _write_rank_payload(stage, rank, step, tree)
    if rank != 0:
        return None

    # ---- rank 0: wait for the gang, then commit ----------------------
    deadline = time.monotonic() + barrier_timeout_s
    metas = {}
    while len(metas) < procs:
        for r in range(procs):
            if r not in metas:
                m = _rank_meta(stage, r)
                if m is not None:
                    metas[r] = m
        if len(metas) == procs:
            break
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"coordinated checkpoint at step {step} timed out "
                f"after {barrier_timeout_s:.0f}s waiting for rank "
                f"payloads {sorted(set(range(procs)) - set(metas))} "
                f"under {stage!r}")
        time.sleep(0.01)

    n_leaves = {m["n_leaves"] for m in metas.values()}
    if len(n_leaves) != 1:
        raise RuntimeError(
            f"coordinated checkpoint at step {step} has inconsistent "
            f"rank payloads (leaf counts {sorted(n_leaves)})")
    meta = {"step": int(step), "ckpt_format": COORDINATED_FORMAT,
            "procs": int(procs), "n_leaves": n_leaves.pop(),
            "rank_crc32": {str(r): metas[r]["crc32"]
                           for r in sorted(metas)}}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(stage, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())

    # the injected rank-0 death: payloads durable, manifest not
    if faults._ACTIVE is not None:
        faults.on_manifest_write(step)

    final = _step_dir(root, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(stage, final)
    _fsync_path(root)

    manifest = _read_manifest(root)
    steps = sorted(set(manifest.get("steps", [])) | {int(step)})
    while len(steps) > keep_last:
        victim = steps.pop(0)
        shutil.rmtree(_step_dir(root, victim), ignore_errors=True)
    _write_manifest(root, {"steps": steps, "keep": keep_last})
    return final


# ------------------------------------------------------------ restore --

def _quarantine_rank_payload(step_dir: str, rank: int,
                             why: Exception) -> None:
    src = os.path.join(step_dir, _rank_name(rank))
    dst = src + ".quarantined"
    n = 1
    while os.path.exists(dst):
        dst = f"{src}.quarantined.{n}"
        n += 1
    log.error("rank-%d payload under %r is corrupt (%s) — quarantining "
              "to %r and falling back to another rank's replicated "
              "state", rank, step_dir, why, dst)
    try:
        os.rename(src, dst)
    except OSError:
        shutil.rmtree(src, ignore_errors=True)


def load_step_arrays(step_dir: str, *, prefer_rank: int = 0) -> dict:
    """A committed coordinated step's arrays, checked against the
    payload's recorded CRCs: ``prefer_rank``'s payload first (this
    process's own), then every other rank ascending.  The preferring
    process quarantines its own torn payload; other ranks' payloads are
    only read, so concurrent restores of a gang cannot race.
    ``CorruptCheckpointError`` when no payload survives."""
    from repro_torch.ckpt.checkpoint import (CorruptCheckpointError,
                                             _load_validated)

    ranks = sorted(
        int(name[len("rank_"):]) for name in os.listdir(step_dir)
        if name.startswith("rank_") and not name.endswith(".tmp")
        and "quarantined" not in name
        and os.path.isdir(os.path.join(step_dir, name)))
    order = ([prefer_rank] if prefer_rank in ranks else []) + \
        [r for r in ranks if r != prefer_rank]
    last_err: Optional[Exception] = None
    for r in order:
        d = os.path.join(step_dir, _rank_name(r))
        try:
            return _load_validated(d, _rank_meta(step_dir, r))
        except CorruptCheckpointError as e:
            last_err = e
            if r == prefer_rank:
                _quarantine_rank_payload(step_dir, r, e)
            else:
                log.error("rank-%d payload under %r is corrupt (%s) — "
                          "trying the next rank", r, step_dir, e)
    raise CorruptCheckpointError(
        f"every rank payload under {step_dir!r} failed validation "
        f"(last: {last_err!r})")
