"""Versioned weight hot-reload for the serving engine (counterpart of
``repro/serving/reload.py``).

The contract (what ``POST /reload`` promises):

  * ATOMIC — the engine's live weights are one immutable ``WeightSet``
    (version string + one params dict per replica device).  A reload
    builds the WHOLE new set off to the side — checkpoint read, shape
    match against the live params, a copy onto every replica — and then
    publishes it with a single reference swap.  A micro-batch reads
    that reference exactly once, so every score is computed against
    exactly the old or exactly the new weights, never a mix, and the
    version echoed with the score is the version that produced it.
  * NON-DISRUPTIVE — requests in flight during the swap keep their
    already-captured WeightSet; nothing is dropped, cancelled or
    re-queued, and the old params are freed once the last in-flight
    batch holding them resolves.
  * VERSIONED — every response carries the model version
    (``ckpt-<step>`` for checkpoint loads unless overridden), so
    clients and canary checks can pin scores to weights bitwise.

Checkpoint sources, tried in order by ``reload_from_checkpoint``:

  1. ``<ckpt_dir>/serve`` — the params-only snapshots ``fit_streaming``
     publishes at every checkpoint boundary (``ckpt.checkpoint
     .publish_params``), the reference's or the port's: both packages
     write the same layout.
  2. ``<ckpt_dir>`` itself, when it holds params-only checkpoints
     (``ckpt.checkpoint.save(dir, step, params)``).

A full training-state checkpoint without a published ``serve/`` subdir
fails loudly with the fix (the leaf counts cannot match), rather than
half-loading an optimizer state as weights.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, List, Optional, Tuple

from repro_torch import bfloat16
from repro_torch.ckpt import checkpoint as ckpt


@dataclasses.dataclass(frozen=True)
class WeightSet:
    """One immutable generation of serving weights: the version tag and
    the per-replica device-resident params (index-aligned with the
    engine's device list)."""
    version: str
    params: Tuple[Any, ...]
    created_at: float = 0.0

    def on(self, device_index: int) -> Any:
        return self.params[device_index]


def load_serving_params(ckpt_dir: str, template: Any,
                        step: Optional[int] = None) -> Tuple[Any, int]:
    """Load a params tree shaped like ``template`` from ``ckpt_dir``
    (published ``serve/`` snapshots first, then params-only checkpoints
    at the root).  → (params, step)."""
    if ckpt.latest_published(ckpt_dir) is not None:
        return ckpt.restore_published(ckpt_dir, template, step)
    try:
        return ckpt.restore(ckpt_dir, template, step)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"no checkpoints under {ckpt_dir!r} (neither published "
            f"serving params in {ckpt_dir}/{ckpt.SERVE_SUBDIR} nor a "
            "root manifest)")
    except ValueError as e:
        raise ValueError(
            f"checkpoint under {ckpt_dir!r} is not a params-only tree "
            "and has no published serving params — train through "
            "fit_streaming(ckpt_dir=...), which publishes the averaged "
            "iterate under <ckpt_dir>/serve at every boundary, or save "
            f"raw params with ckpt.checkpoint.save: {e}") from e


class ReloadManager:
    """Serialized hot-reloads against one engine.

    One reload at a time (a lock, not a queue: concurrent ``/reload``
    posts would otherwise race their copies and publish out of order);
    scoring traffic is never blocked — it keeps reading whichever
    ``WeightSet`` is current.
    """

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self.history: List[dict] = []

    @property
    def version(self) -> str:
        return self.engine.version

    def swap(self, params: Any, version: Optional[str] = None) -> dict:
        """Swap in an in-memory params dict (the live params' keys and
        shapes); → {"version", "previous"}."""
        with self._lock:
            previous = self.engine.version
            ver = self.engine.swap_weights(params, version)
            info = {"version": ver, "previous": previous,
                    "reloads": self.engine.reloads, "at": time.time()}
            self.history.append(info)
            return dict(info)

    def reload_from_checkpoint(self, ckpt_dir: str,
                               step: Optional[int] = None,
                               version: Optional[str] = None) -> dict:
        """Load + swap; → {"version", "previous", "step", "ckpt_dir"}.

        Raises ``FileNotFoundError`` (no checkpoint there) or
        ``ValueError`` (structure mismatch) without touching the live
        weights — a failed reload leaves serving exactly as it was.
        The template is the live params as host numpy arrays (a
        bfloat16 table as its ``|V2`` words), so the restored leaves land
        on the host in the live dtype (a float32 snapshot rounded to a
        bfloat16 engine's, as the reference's template casts it) and
        ``swap_weights`` copies them onto every replica.
        """
        with self._lock:
            template = {name: bfloat16.to_numpy(t)
                        for name, t in self.engine.params.items()}
            params, got_step = load_serving_params(ckpt_dir, template,
                                                   step)
            previous = self.engine.version
            ver = self.engine.swap_weights(
                params, version or f"ckpt-{got_step}")
            info = {"version": ver, "previous": previous,
                    "step": int(got_step), "ckpt_dir": ckpt_dir,
                    "reloads": self.engine.reloads, "at": time.time()}
            self.history.append(info)
            return dict(info)
