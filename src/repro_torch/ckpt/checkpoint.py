"""Atomic, checksummed, manifest-tracked checkpoints (counterpart of
``repro/ckpt/checkpoint.py``; the reference's layout; a gang's
coordinated steps are ``ckpt.coordinated``'s).

  <dir>/manifest.json            {"steps": [100, 200, ...], "keep": 3}
  <dir>/step_00000200/ckpt.npz   leaf_00000, leaf_00001, ...
  <dir>/step_00000200/meta.json  {"step", "n_leaves", "ckpt_format": 4,
                                  "crc32": {leaf_00000: ..., ...},
                                  ...the caller's extra_meta}
  <dir>/quarantine/step_...      corrupt checkpoints moved aside
  <dir>/serve/...                params-only snapshots for serving

Leaves are the tree's in the reference's order (``repro_torch.tree``:
dict keys sorted, dataclass fields in order), as numpy arrays, so the
reference's ``restore_published`` reads the port's published
``{"bias", "table"}`` and the other way round.

  * **atomic and durable**: leaves and metadata go to ``.tmp-<step>``,
    are fsync'd (contents and the directory entry), then renamed into
    place;
  * **integrity**: every leaf's CRC32 is in ``meta.json``; ``restore``
    recomputes and compares;
  * **quarantine and fallback**: a corrupt checkpoint is logged, moved
    under ``quarantine/`` and dropped from the manifest; ``restore``
    falls back to the newest valid step, and raises
    ``FileNotFoundError`` only when none is left;
  * **keep-last-M** pruning, the manifest the one record of which steps
    exist;
  * **restore into a template**: leaves are matched by position against
    the live tree and land as tensors on each template tensor's device
    (numpy for numpy leaves).

An armed ``ft.faults`` plan's ``ckpt_write`` event tears a save: the
payload is truncated after the atomic rename, the manifest updated, then
``InjectedCrash`` raised.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import bfloat16
from repro_torch import tree as _tree
from repro_torch.ft import faults

CKPT_FORMAT = 4
QUARANTINE_SUBDIR = "quarantine"
SERVE_SUBDIR = "serve"

log = logging.getLogger("repro_torch.ckpt")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed validation (unreadable npz or CRC mismatch)."""


def run_fingerprint(payload: dict) -> np.int64:
    """Stable int64 fingerprint of run-defining settings: the SHA-256 of
    their sorted-key JSON, truncated to 63 bits.  A resumed run compares
    it with its own and refuses a mismatch (same tree structure,
    different run)."""
    src = json.dumps(payload, sort_keys=True)
    return np.int64(
        int.from_bytes(hashlib.sha256(src.encode()).digest()[:8],
                       "big") >> 1)


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def _manifest_path(root: str) -> str:
    return os.path.join(root, "manifest.json")


def _read_manifest(root: str) -> dict:
    try:
        with open(_manifest_path(root)) as f:
            return json.load(f)
    except FileNotFoundError:
        return {"steps": []}


def _write_manifest(root: str, manifest: dict) -> None:
    tmp = _manifest_path(root) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, _manifest_path(root))


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        # a bfloat16 tensor as its 2-byte words, stored as the reference's
        # bfloat16 arrays are (void, '|V2')
        return bfloat16.to_numpy(x)
    return np.asarray(x)


def save(root: str, step: int, tree: Any, keep_last: int = 3, *,
         extra_meta: Optional[dict] = None) -> str:
    """Saves a snapshot of ``tree``; prunes old steps; returns the step
    dir.  ``extra_meta`` entries are merged into ``meta.json``
    (``load_meta``)."""
    os.makedirs(root, exist_ok=True)
    leaves = _tree.leaves(tree)
    arrays = {f"leaf_{i:05d}": _host(x) for i, x in enumerate(leaves)}
    directive = (faults.on_ckpt_write(step)
                 if faults._ACTIVE is not None else None)
    tmp = os.path.join(root, f".tmp-{step}")
    os.makedirs(tmp, exist_ok=True)
    payload = os.path.join(tmp, "ckpt.npz")
    np.savez(payload, **arrays)
    meta = {"step": int(step), "n_leaves": len(leaves),
            "ckpt_format": CKPT_FORMAT,
            "crc32": {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                      for k, v in arrays.items()}}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if directive == "torn":
        # the injected failure: the rename becomes durable but the
        # payload pages never reach the disk — truncate after the write,
        # skip the payload's fsync, publish, then crash
        size = os.path.getsize(payload)
        with open(payload, "r+b") as f:
            f.truncate(max(1, int(size * 0.6)))
    else:
        _fsync_path(payload)
    final = _step_dir(root, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_path(root)

    manifest = _read_manifest(root)
    steps = sorted(set(manifest.get("steps", [])) | {int(step)})
    while len(steps) > keep_last:
        victim = steps.pop(0)
        shutil.rmtree(_step_dir(root, victim), ignore_errors=True)
    _write_manifest(root, {"steps": steps, "keep": keep_last})
    if directive == "torn":
        raise faults.InjectedCrash(
            f"injected torn checkpoint write at step {step}")
    return final


def latest_step(root: str) -> Optional[int]:
    steps = _read_manifest(root).get("steps", [])
    return max(steps) if steps else None


def load_meta(root: str, step: int) -> Optional[dict]:
    """The ``meta.json`` of one checkpoint step (None if unreadable)."""
    try:
        with open(os.path.join(_step_dir(root, step), "meta.json")) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None


def _quarantine(root: str, step: int, why: Exception) -> None:
    qdir = os.path.join(root, QUARANTINE_SUBDIR)
    os.makedirs(qdir, exist_ok=True)
    src = _step_dir(root, step)
    dst = os.path.join(qdir, os.path.basename(src))
    n = 1
    while os.path.exists(dst):
        dst = os.path.join(qdir, f"{os.path.basename(src)}.{n}")
        n += 1
    log.error("checkpoint step %d under %r is corrupt (%s) — "
              "quarantining to %r and falling back to the newest valid "
              "checkpoint", step, root, why, dst)
    try:
        os.rename(src, dst)
    except OSError:
        shutil.rmtree(src, ignore_errors=True)
    manifest = _read_manifest(root)
    steps = [s for s in manifest.get("steps", []) if int(s) != int(step)]
    _write_manifest(root, {"steps": steps,
                           "keep": manifest.get("keep", 3)})


def _load_validated(d: str, meta: Optional[dict]) -> dict:
    """npz → {name: array}, CRC-checked when the meta records CRCs;
    ``CorruptCheckpointError`` on any parse or CRC failure."""
    try:
        with np.load(os.path.join(d, "ckpt.npz")) as data:
            arrays = {name: np.asarray(data[name]) for name in data.files}
    except Exception as e:  # a torn zip: BadZipFile, OSError, EOF, ...
        raise CorruptCheckpointError(f"unreadable ckpt.npz: {e!r}") from e
    crcs = (meta or {}).get("crc32")
    if crcs:  # format-3 checkpoints predate CRCs: parse-check only
        for name, arr in arrays.items():
            want = crcs.get(name)
            got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if want is None or int(want) != got:
                raise CorruptCheckpointError(
                    f"CRC mismatch on {name} (recorded {want}, "
                    f"recomputed {got})")
    return arrays


def _like(arr: np.ndarray, leaf: Any):
    """``arr`` in the dtype, shape and place of the template ``leaf``;
    bfloat16 words (a bfloat16 tensor's, or a ``|V2`` array's) are kept
    bit for bit, rounded to from a float array, or widened exactly to a
    float template (``bfloat16.cast_like``)."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        arr = np.asarray(arr)
        if arr.dtype.itemsize == 2 and arr.dtype.kind in "Vui":
            words = np.array(arr.view(np.int16)).reshape(tuple(leaf.shape))
            return torch.from_numpy(words).view(torch.bfloat16).to(
                leaf.device)
        return torch.tensor(arr.astype(np.float32)).to(
            torch.bfloat16).reshape(tuple(leaf.shape)).to(leaf.device)
    if isinstance(leaf, torch.Tensor):
        want = torch.empty((), dtype=leaf.dtype).numpy().dtype
        # np.array keeps a 0-d leaf 0-d (ascontiguousarray would not)
        host = np.array(bfloat16.cast_like(arr, want)).reshape(
            tuple(leaf.shape))
        return torch.from_numpy(host).to(leaf.device)
    return bfloat16.cast_like(arr, np.asarray(leaf).dtype).reshape(
        np.shape(leaf))


def restore(root: str, template: Any, step: Optional[int] = None, *,
            validate: bool = True,
            fallback: Optional[bool] = None) -> Tuple[Any, int]:
    """Loads leaves into the structure of ``template`` → ``(tree, step)``.

    With ``step=None`` candidates are walked newest first; one failing
    validation is quarantined and the next tried (``fallback`` defaults
    to True then); when none is valid, ``FileNotFoundError``.  An
    explicit ``step`` never falls back: corruption raises
    ``CorruptCheckpointError``.  A leaf-count mismatch with the template
    raises ``ValueError`` (structure, not corruption: nothing is
    quarantined).

    A step of a gang (``ckpt.coordinated``: a payload a rank, no
    top-level ``ckpt.npz``) restores through the same walk: this
    process's own rank payload is preferred, any valid rank's replicated
    payload is accepted, and only a step with no valid payload is
    corrupt.  So a single process resumes a gang's checkpoint (N → 1)
    and a gang a single process's (1 → N)."""
    if fallback is None:
        fallback = step is None
    if step is None:
        steps = sorted(_read_manifest(root).get("steps", []), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
    else:
        steps = [int(step)]
    last_err: Optional[Exception] = None
    for s in steps:
        d = _step_dir(root, s)
        try:
            from repro_torch.ckpt import coordinated
            if coordinated.is_coordinated_dir(d):
                from repro_torch.distributed.runtime import current_rank
                arrays = coordinated.load_step_arrays(
                    d, prefer_rank=current_rank())
            else:
                arrays = _load_validated(d, load_meta(root, s)
                                         if validate else None)
        except CorruptCheckpointError as e:
            last_err = e
            if not fallback:
                raise
            _quarantine(root, s, e)
            continue
        leaves_t = _tree.leaves(template)
        if len(leaves_t) != len(arrays):
            raise ValueError(
                f"checkpoint has {len(arrays)} leaves, template has "
                f"{len(leaves_t)} — incompatible structure")
        leaves = [_like(arrays[f"leaf_{i:05d}"], leaf)
                  for i, leaf in enumerate(leaves_t)]
        return _tree.unflatten(template, leaves), int(s)
    raise FileNotFoundError(
        f"no valid checkpoints under {root} (last corruption: "
        f"{last_err!r})")


def restore_if_exists(root: str, template: Any):
    try:
        return restore(root, template)
    except (FileNotFoundError, ValueError):
        return None


# --------------------------------------------------- serving handoff ----
# A training checkpoint is the whole state restored against the
# trainer's own template; a server has only its params.  publish_params
# writes a params-only snapshot under <root>/serve with the same
# atomic-rename, checksum and manifest discipline.

def publish_params(root: str, step: int, params: Any,
                   keep_last: int = 3) -> str:
    """Publishes a params-only snapshot under ``<root>/serve``; returns
    the step dir."""
    return save(os.path.join(root, SERVE_SUBDIR), step, params,
                keep_last=keep_last)


def latest_published(root: str) -> Optional[int]:
    return latest_step(os.path.join(root, SERVE_SUBDIR))


def restore_published(root: str, template: Any,
                      step: Optional[int] = None) -> Tuple[Any, int]:
    """Restores the latest (or the given step's) published params."""
    return restore(os.path.join(root, SERVE_SUBDIR), template, step)
