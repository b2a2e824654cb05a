"""Deterministic, seeded fault injection for the streaming trainer and
its multi-process gang (counterpart of ``repro/ft/faults.py``).

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

Across the ranks of a gang (``distributed.runtime``):

  * every event carries an optional ``rank``: it fires only in the
    process whose ``set_rank`` matches (``None``: any rank), so one plan
    shipped to every worker kills exactly rank k;
  * ``"proc_kill"`` is a real death: ``SIGKILL`` to self at the named
    step, no exception and no cleanup.  ``"manifest_write"`` kills rank 0
    after the coordinated checkpoint's rank payloads are durable and
    before the step manifest commits (``ckpt.coordinated``);
  * plans survive respawns: ``state_path`` keeps each event's ``fired``
    count (written before any kill or raise), so a ``times=1`` kill does
    not fire again after the supervisor restarts the gang.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import time
from typing import List, Optional

__all__ = [
    "FaultEvent", "FaultPlan", "InjectedCrash", "arm", "arm_plan",
    "disarm", "active", "set_rank", "current_rank", "on_train_step",
    "on_shard_read", "on_ckpt_write", "on_manifest_write",
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
        after the atomic rename, then ``InjectedCrash`` is raised;
      * ``"proc_kill"``: ``SIGKILL`` to self before train step ``step``;
      * ``"manifest_write"``: kill the committing rank of a coordinated
        checkpoint at save step ``at_save`` (``None``: the next save)
        after every rank payload is durable, before the manifest
        commits.

    ``rank`` scopes the event to one process of a gang (``None``: any
    rank; a single process is rank 0).  ``times`` bounds how often the
    event fires (``None``: every match); ``fired`` counts firings.
    """
    site: str
    step: Optional[int] = None
    shard: Optional[int] = None
    at_save: Optional[int] = None
    rank: Optional[int] = None
    times: Optional[int] = 1
    delay_s: float = 0.0
    mode: str = "torn"
    fired: int = 0

    def _rank_matches(self) -> bool:
        return self.rank is None or self.rank == _RANK

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
    each failure exactly as scripted.  ``state_path`` carries the firing
    counts across process deaths: they are written there (atomically,
    before the failure is delivered) and read back by ``load_state`` in
    the respawned worker."""
    events: List[FaultEvent]
    seed: int = 0
    state_path: Optional[str] = None

    def matching(self, site: str):
        return [e for e in self.events if e.site == site
                and e._rank_matches()]

    def to_spec(self) -> dict:
        """A JSON-safe description (firing counts excluded: they travel
        through ``state_path``), to ship the plan to gang workers."""
        evs = []
        for e in self.events:
            d = dataclasses.asdict(e)
            d.pop("fired")
            evs.append(d)
        return {"events": evs, "seed": self.seed}

    @classmethod
    def from_spec(cls, spec: dict,
                  state_path: Optional[str] = None) -> "FaultPlan":
        plan = cls([FaultEvent(**ev) for ev in spec.get("events", [])],
                   seed=int(spec.get("seed", 0)),
                   state_path=state_path)
        plan.load_state()
        return plan

    def load_state(self) -> None:
        if not self.state_path:
            return
        try:
            with open(self.state_path) as f:
                fired = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return
        for i, ev in enumerate(self.events):
            ev.fired = int(fired.get(str(i), ev.fired))

    def persist_state(self) -> None:
        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(i): ev.fired
                       for i, ev in enumerate(self.events)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)


_ACTIVE: Optional[FaultPlan] = None
_RANK: int = 0


def set_rank(rank: int) -> None:
    """Declares this process's gang rank (``distributed.runtime
    .init_runtime`` calls it); rank-scoped events compare against it."""
    global _RANK
    _RANK = int(rank)


def current_rank() -> int:
    return _RANK


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
            plan.persist_state()
            time.sleep(ev.delay_s)
    for ev in plan.matching("proc_kill"):
        if ev.step == step and ev._take():
            # a real worker death: the firing is persisted first (the
            # respawned process must not fire again), then kill -9
            plan.persist_state()
            os.kill(os.getpid(), signal.SIGKILL)
    for ev in plan.matching("train_step"):
        if ev.step == step and ev._take():
            plan.persist_state()
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
            plan.persist_state()
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
            plan.persist_state()
            return ev.mode
    return None


def on_manifest_write(step: int) -> None:
    """Called by ``ckpt.coordinated`` on the committing rank after every
    rank payload is durable, just before the step manifest commits; a
    matching event kills the process."""
    plan = _ACTIVE
    if plan is None:
        return
    for ev in plan.matching("manifest_write"):
        if (ev.at_save is None or ev.at_save == step) and ev._take():
            plan.persist_state()
            os.kill(os.getpid(), signal.SIGKILL)
