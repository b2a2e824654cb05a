"""Deterministic, seeded fault injection for the streaming trainer (the
single-process sites of the reference's ``ft/faults.py``).

A ``FaultPlan`` is an ordered list of ``FaultEvent``s, each naming a
hook site and a trigger (step / shard / checkpoint step) plus how many
times it fires (``times=None``: every match, the model of a corrupt
disk block rather than a transient hiccup).  ``arm(plan)`` installs the
plan process-wide; ``train.streaming.fit_streaming``,
``data.hashed_dataset.load_packed_shard`` and ``ckpt.checkpoint.save``
consult it.  Every call site guards on the module global first::

    if faults._ACTIVE is not None:
        faults.on_train_step(step)

so an unarmed run pays one global load and an identity check.  Firing
counts live on the plan (``FaultEvent.fired``), so one plan armed
across a supervised restart loop injects its crash exactly ``times``
times and then lets the retries succeed.

Injected failures are ordinary exceptions: ``InjectedCrash`` (a
``RuntimeError``, which the supervisor treats like any crash) and a
plain ``IOError`` for shard reads (absorbed by the reader's bounded
retry like a real transient error).  The torn-checkpoint event returns
a directive and ``ckpt.checkpoint.save`` implements the tear itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

__all__ = [
    "FaultEvent", "FaultPlan", "InjectedCrash", "arm", "arm_plan",
    "disarm", "active", "on_train_step", "on_shard_read", "on_ckpt_write",
]


class InjectedCrash(RuntimeError):
    """A planned crash: raised out of a hook site and, in the supervised
    loop, handled like any other crash."""


@dataclasses.dataclass
class FaultEvent:
    """One planned failure.  ``site`` selects the hook:

      * ``"train_step"``: raise ``InjectedCrash`` when the trainer's
        global step equals ``step``;
      * ``"slow_step"``: sleep ``delay_s`` before that step runs (the
        straggler the ``StepWatchdog`` should flag);
      * ``"shard_read"``: raise ``IOError`` from the packed-shard reader
        when it opens shard ``shard`` (``None``: any shard);
      * ``"ckpt_write"``: tear the checkpoint written at checkpoint step
        ``at_save`` (``None``: the next save): the payload is truncated
        after the atomic rename, then ``InjectedCrash`` is raised.

    ``times`` bounds how often the event fires (``None``: every match);
    ``fired`` counts firings.
    """
    site: str
    step: Optional[int] = None
    shard: Optional[int] = None
    at_save: Optional[int] = None
    times: Optional[int] = 1
    delay_s: float = 0.0
    mode: str = "torn"
    fired: int = 0

    def _take(self) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True


@dataclasses.dataclass
class FaultPlan:
    """An ordered set of planned failures, armed process-wide by
    ``arm``/``arm_plan``.  Each event remembers how often it fired, so
    the same plan armed across a supervised restart sequence injects
    each failure exactly as scripted."""
    events: List[FaultEvent]
    seed: int = 0

    def matching(self, site: str):
        return [e for e in self.events if e.site == site]


_ACTIVE: Optional[FaultPlan] = None


def arm_plan(plan: Optional[FaultPlan]) -> None:
    """Installs ``plan`` process-wide (``None`` disarms)."""
    global _ACTIVE
    _ACTIVE = plan


def disarm() -> None:
    arm_plan(None)


def active() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def arm(plan: FaultPlan):
    """Context manager: arm ``plan`` for the enclosed block only."""
    prev = _ACTIVE
    arm_plan(plan)
    try:
        yield plan
    finally:
        arm_plan(prev)


# ------------------------------------------------------- hook sites ----

def on_train_step(step: int) -> None:
    """Called by the trainer before it runs global step ``step``."""
    plan = _ACTIVE
    if plan is None:
        return
    for ev in plan.matching("slow_step"):
        if ev.step == step and ev._take():
            time.sleep(ev.delay_s)
    for ev in plan.matching("train_step"):
        if ev.step == step and ev._take():
            raise InjectedCrash(f"injected crash at train step {step}")


def on_shard_read(root: str, shard: int) -> None:
    """Called by the packed-shard reader before it touches the shard's
    files, inside its retry loop: a transient event (small ``times``)
    is absorbed by the retries, a persistent one exhausts them."""
    plan = _ACTIVE
    if plan is None:
        return
    for ev in plan.matching("shard_read"):
        if (ev.shard is None or ev.shard == shard) and ev._take():
            raise IOError(
                f"injected transient IOError reading shard {shard} "
                f"of {root!r} (firing {ev.fired}"
                f"{'' if ev.times is None else f'/{ev.times}'})")


def on_ckpt_write(step: int) -> Optional[str]:
    """Called by ``ckpt.checkpoint.save``: a directive (``"torn"``) when
    this save is to be sabotaged, else ``None``."""
    plan = _ACTIVE
    if plan is None:
        return None
    for ev in plan.matching("ckpt_write"):
        if (ev.at_save is None or ev.at_save == step) and ev._take():
            return ev.mode
    return None
