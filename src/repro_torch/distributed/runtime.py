"""Multi-process runtime over ``torch.distributed`` (counterpart of
``repro/distributed/runtime.py``).

A training gang is ``procs`` cooperating processes, each owning a
contiguous block of the logical shard slots (``process_slot_range``) and
``local_devices`` data devices of its own.  Everything topology-shaped
lives here:

  * ``init_runtime``: the bootstrap.  ``procs == 1`` creates no process
    group (a single process pays nothing for the runtime), unless the
    caller names a ``backend``, which makes a group of one rank.
    ``procs > 1`` calls ``torch.distributed.init_process_group`` over
    TCP at the coordinator's ``host:port``.  The backend rule:

      - **NCCL** when each rank has a card of its own: the device is
        CUDA and the box has at least ``procs · local_devices`` cards;
      - **gloo** otherwise: on the CPU, or when ranks share a card
        (NCCL refuses two ranks on one GPU).

    It also tells ``ft.faults`` this process's rank, so rank-scoped
    fault events fire on the right process;
  * ``ProcessRuntime``: the record the trainer threads through: gang
    size, rank, coordinator, devices per rank, run directory, the
    backend of its group (``None``: no group) and the rank's first
    device;
  * ``process_devices``: rank r's data devices on a CUDA box are
    ``cuda:((r·L + i) mod cards)`` for i < L, so with one device each
    rank r uses ``cuda:(r mod cards)``; on the CPU they are L handles to
    the CPU;
  * ``DataMesh`` / ``mesh_over_processes``: the gang's data world, the
    ordered list of (rank, device) the reference's mesh orders by
    ``(process_index, id)``; process p's devices hold global slots
    ``[p·L, (p+1)·L)``;
  * ``replicate_across_processes``: rank 0's tensors broadcast to every
    rank, in place (the ranks draw the same start from the same seed, so
    this only makes the same-state contract explicit);
  * **heartbeats**: each rank writes an atomic
    ``<run_dir>/hb/rank_<r>.json`` at every shard boundary with its rank,
    step and wall clock, the same records as the reference's.

The process topology is not part of the run fingerprint: the slot
ownership rule (``"contiguous_slots"``) is, while the gang size rides
the topology lineage, so a checkpoint written by N processes resumes on
M ≠ N under ``elastic=True`` (``train.streaming``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.ft import faults
from repro_torch import tree as _tree

__all__ = [
    "ProcessRuntime", "DataMesh", "init_runtime", "shutdown_runtime",
    "current_runtime", "current_rank", "choose_backend",
    "process_devices", "mesh_over_processes",
    "replicate_across_processes", "process_slot_range", "heartbeat",
    "read_heartbeats",
]

SHARD_OWNERSHIP = "contiguous_slots"

_CURRENT: Optional["ProcessRuntime"] = None


def current_runtime() -> Optional["ProcessRuntime"]:
    """The runtime ``init_runtime`` registered (None before, as in every
    plain single-process run)."""
    return _CURRENT


def current_rank() -> int:
    """This process's gang rank (0 when no runtime was initialized)."""
    return _CURRENT.rank if _CURRENT is not None else 0


@dataclasses.dataclass(frozen=True)
class ProcessRuntime:
    """One process's view of the training gang."""
    procs: int = 1                 # gang size (1: a single process)
    rank: int = 0                  # this process's id in [0, procs)
    coordinator: str = ""          # "host:port" ("" without a group)
    local_devices: int = 1         # data devices this process contributes
    run_dir: Optional[str] = None  # heartbeat / gang bookkeeping root
    backend: Optional[str] = None  # "nccl" | "gloo"; None: no group
    device: str = ""               # the rank's first device

    @property
    def is_multiprocess(self) -> bool:
        return self.procs > 1

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @property
    def group(self):
        """The process group of the collectives (None: no group)."""
        if self.backend is None:
            return None
        import torch.distributed as dist
        return dist.group.WORLD


def choose_backend(device: torch.device, procs: int,
                   local_devices: int = 1) -> str:
    """NCCL when every rank has cards of its own, gloo otherwise."""
    if (device.type == "cuda"
            and torch.cuda.device_count() >= procs * local_devices):
        return "nccl"
    return "gloo"


def process_devices(device: DeviceLike, rank: int,
                    n: int = 1) -> List[torch.device]:
    """Rank ``rank``'s ``n`` data devices: ``cuda:((rank·n + i) mod
    cards)`` on a CUDA box (ranks share cards when there are fewer),
    ``n`` handles to the CPU otherwise."""
    base = resolve_device(device)
    if base.type != "cuda":
        return [base] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", (rank * n + i) % cards) for i in range(n)]


def init_runtime(
    procs: int = 1,
    rank: int = 0,
    coordinator: Optional[str] = None,
    run_dir: Optional[str] = None,
    *,
    device: DeviceLike = None,
    local_devices: int = 1,
    backend: Optional[str] = None,
) -> ProcessRuntime:
    """Joins this process to a ``procs``-wide gang → its record.

    ``device`` names the device type (default ``cuda``; ``"cpu"`` for
    the CPU): rank r's devices follow ``process_devices``.  ``backend``
    overrides the rule of the module docstring (with ``procs == 1`` it
    makes a one-rank group, for checking a backend's collectives
    against the group-free run).  ``shutdown_runtime`` leaves the
    group.
    """
    if procs < 1:
        raise ValueError(f"procs must be >= 1, got {procs}")
    if not 0 <= rank < procs:
        raise ValueError(f"rank {rank} outside [0, {procs})")
    if local_devices < 1:
        raise ValueError(f"local_devices must be >= 1, got {local_devices}")
    if (procs > 1 or backend is not None) and not coordinator:
        raise ValueError(
            "multi-process init needs a coordinator address "
            "(host:port) shared by every rank")
    first = process_devices(device, rank, local_devices)[0]
    if procs > 1 or backend is not None:
        import torch.distributed as dist
        backend = backend or choose_backend(first, procs, local_devices)
        if backend == "nccl":
            torch.cuda.set_device(first)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=procs, rank=rank)
    faults.set_rank(rank)
    rt = ProcessRuntime(procs=procs, rank=rank,
                        coordinator=coordinator or "",
                        local_devices=int(local_devices), run_dir=run_dir,
                        backend=backend, device=str(first))
    global _CURRENT
    _CURRENT = rt
    if run_dir:
        heartbeat(rt, phase="init")
    return rt


def shutdown_runtime() -> None:
    """Leaves the process group (if any) and forgets the runtime."""
    global _CURRENT
    if _CURRENT is not None and _CURRENT.backend is not None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    _CURRENT = None
    faults.set_rank(0)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data-parallel world seen from one process: its ``devices``
    (L of them: global device slots ``[rank·L, (rank+1)·L)`` of
    ``procs·L``), the ordered (rank, device) list of the whole world,
    and the group its collectives run over (None: no collective, the one
    process holds the whole world)."""
    devices: Tuple[torch.device, ...]
    procs: int = 1
    rank: int = 0
    group: Any = None
    placement: Tuple[Tuple[int, str], ...] = ()

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def physical(self) -> int:
        return self.procs * len(self.devices)


def mesh_over_processes(d_local: int, rt: ProcessRuntime,
                        device: DeviceLike = None) -> DataMesh:
    """The gang's data mesh: the first ``d_local`` of each rank's
    ``rt.local_devices`` devices, ordered by (rank, device); this
    process's devices and group."""
    if d_local > rt.local_devices:
        raise ValueError(
            f"process {rt.rank} has {rt.local_devices} devices but the "
            f"mesh needs {d_local} per process")
    per_rank = [process_devices(device, r, rt.local_devices)[:d_local]
                for r in range(rt.procs)]
    return DataMesh(devices=tuple(per_rank[rt.rank]), procs=rt.procs,
                    rank=rt.rank, group=rt.group,
                    placement=tuple((r, str(d))
                                    for r, devs in enumerate(per_rank)
                                    for d in devs))


@torch.no_grad()
def replicate_across_processes(tree: Any, mesh: DataMesh) -> Any:
    """Every tensor leaf of ``tree`` made rank 0's, by a broadcast over
    the mesh's group, in place (numpy leaves stay: they are the same
    host values on every rank); the tree without a group."""
    if mesh.group is None:
        return tree
    import torch.distributed as dist
    for leaf in _tree.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            dist.broadcast(leaf, src=0, group=mesh.group)
    return tree


def process_slot_range(logical: int, procs: int,
                       rank: int) -> Tuple[int, int]:
    """The contiguous block of logical shard slots rank ``rank`` owns;
    ``logical`` must split evenly (uneven blocks would give ranks
    different step counts and deadlock the collectives)."""
    if logical % procs:
        raise ValueError(
            f"data_parallel={logical} logical shard slots cannot split "
            f"evenly over {procs} processes — choose procs dividing "
            "the logical world")
    per = logical // procs
    return rank * per, (rank + 1) * per


# ------------------------------------------------------- heartbeats ----

def _hb_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "hb")


def heartbeat(rt: ProcessRuntime, *, step: int = 0,
              shards_done: int = 0, phase: str = "train") -> None:
    """Atomically publishes this rank's liveness and progress record."""
    if not rt.run_dir:
        return
    d = _hb_dir(rt.run_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"rank_{rt.rank:05d}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"rank": rt.rank, "procs": rt.procs, "phase": phase,
                   "step": int(step), "shards_done": int(shards_done),
                   "time": time.time(), "pid": os.getpid()}, f)
    os.replace(tmp, path)


def read_heartbeats(run_dir: str) -> dict:
    """Every rank's latest heartbeat record, keyed by rank."""
    out: dict = {}
    d = _hb_dir(run_dir)
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return out
    for name in names:
        if not (name.startswith("rank_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                rec = json.load(f)
            out[int(rec["rank"])] = rec
        except (OSError, ValueError, KeyError):
            continue
    return out
