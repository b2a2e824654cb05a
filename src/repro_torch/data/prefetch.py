"""Shard/minibatch prefetch for the streaming trainer: the producer →
queue → device pipeline (counterpart of ``repro/data/prefetch.py``).

  producer thread                        consumer (train loop)
  ───────────────                        ─────────────────────
  walk the deterministic shard order ─┐
  mmap the shard, fault in its pages  │   bounded  ┌─ step(batch i)
  permute + slice the next minibatch  ├─▶ Queue   ─┤  step(batch i+1)
  copy to the card (side stream)     ─┘  (depth)   └─ drain hits / ckpt

  * ``shard_order``: the epoch's shard permutation, a pure function of
    ``(seed, epoch)``;
  * ``serial_batch_stream`` / ``group_batch_stream``: plain generators of
    ``StreamBatch`` / ``Boundary`` events for the serial and the
    data-parallel (shards grouped across slots) schedules.  A generator
    is its schedule: run inline (prefetch off) or through the thread
    (prefetch on), it executes the same code on the same values;
  * ``ThreadedPrefetcher``: runs any event generator in a bounded daemon
    thread, ``depth`` ≥ 1 items ahead.

On the card the ``transfer`` function of ``train.streaming`` copies each
batch from pinned memory on a side CUDA stream and hands back an event
(``StreamBatch.ready``); the consumer makes its stream wait on it before
the step.  So prefetch changes when host work and copies happen, never
what is produced: any depth, 0 included, gives the same events, and
``fit_streaming`` the same bytes.

A producer exception surfaces in the consumer at the point of the failed
event, with the producer's traceback; a failure inside a shard's read or
slice is wrapped in ``ShardStreamError`` with its (shard, epoch,
position).  A producer thread that dies without posting its sentinel is
detected instead of blocking the consumer forever; ``close()`` unblocks
and joins the thread.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.hashed_dataset import iter_hashed_batches

__all__ = [
    "StreamBatch", "Boundary", "ShardStreamError", "shard_order",
    "serial_batch_stream", "group_batch_stream", "ThreadedPrefetcher",
]


class ShardStreamError(RuntimeError):
    """A shard's read/slice path failed inside a batch stream; carries the
    (shard, epoch, position) the stream died at, the original failure
    chained as ``__cause__``."""

    def __init__(self, msg: str, *, shard: int, epoch: int,
                 position: int):
        super().__init__(msg)
        self.shard = shard
        self.epoch = epoch
        self.position = position


@dataclasses.dataclass
class StreamBatch:
    """One training step's data: ``args`` the tail of the train step's
    call, ``(batch, labels)`` serial and ``(batch, labels, valid)``
    data-parallel; ``n_rows`` the real examples inside (padding
    excluded); ``ready`` the CUDA event after the batch's copy to the
    card (None on the CPU)."""
    args: tuple
    n_rows: int
    ready: Optional[Any] = None


@dataclasses.dataclass
class Boundary:
    """End of a shard (serial) or shard group (data-parallel): the
    trainer drains hit counters, advances
    ``shards_done`` by ``shards_consumed`` and may checkpoint at
    ``(next_epoch, next_pos)``, the position a resumed run restarts
    from."""
    next_epoch: int
    next_pos: int
    shards_consumed: int


def shard_order(seed: int, epoch: int, n_shards: int,
                shuffle: bool) -> np.ndarray:
    """The epoch's shard visit order, a pure function of
    ``(seed, epoch)``, so a restarted run replays it exactly."""
    if not shuffle:
        return np.arange(n_shards)
    rng = np.random.default_rng(np.random.SeedSequence((seed, epoch)))
    return rng.permutation(n_shards)


def _mask_consistent(bem, has_empty: bool, shard: int, root: str) -> None:
    if (bem is None) == has_empty:
        raise ValueError(
            f"shard {shard} of {root!r} "
            f"{'lacks' if bem is None else 'carries'} an empty bitmask "
            f"while shard 0 {'has one' if has_empty else 'does not'} — "
            "archive written with desynced empty masks?")


def serial_batch_stream(
    root: str, batch_size: int, *, seed: int, epochs: int, n_shards: int,
    shuffle: bool, start_epoch: int, start_pos: int, has_empty: bool,
    transfer: Callable[..., tuple], mmap: bool = True,
) -> Iterator[Any]:
    """Single-device event stream: one shard at a time, minibatches in
    the deterministic ``(seed, epoch, shard)`` permutation.

    ``transfer(packed, empty|None, labels) -> ((batch, labels), ready)``
    moves a batch to the device; it runs on whichever thread iterates
    this generator.
    """
    for epoch in range(start_epoch, epochs):
        order = shard_order(seed, epoch, n_shards, shuffle)
        first = start_pos if epoch == start_epoch else 0
        for pos in range(first, n_shards):
            s = int(order[pos])
            try:
                for bp, bl, _rid, bem in iter_hashed_batches(
                        root, batch_size, shard_ids=[s],
                        perm_seed=(seed, epoch), mmap=mmap):
                    _mask_consistent(bem, has_empty, s, root)
                    args, ready = transfer(bp, bem, bl)
                    yield StreamBatch(args, len(bl), ready)
            except Exception as e:
                # GeneratorExit (consumer close) is a BaseException and
                # passes
                raise ShardStreamError(
                    f"shard {s} failed at epoch {epoch} position {pos} "
                    f"of {root!r}: {e}", shard=s, epoch=epoch,
                    position=pos) from e
            next_epoch, next_pos = ((epoch, pos + 1)
                                    if pos + 1 < n_shards
                                    else (epoch + 1, 0))
            yield Boundary(next_epoch, next_pos, 1)


def group_batch_stream(
    root: str, batch_size: int, *, seed: int, epochs: int, n_shards: int,
    counts: Sequence[int], world: int, shuffle: bool, start_epoch: int,
    start_pos: int, has_empty: bool, packed_width: int, mask_width: int,
    transfer: Callable[..., tuple], mmap: bool = True,
    slot_range: Optional[Tuple[int, int]] = None,
) -> Iterator[Any]:
    """Data-parallel event stream: consecutive groups of ``world`` shards
    of the epoch order, one shard a slot, in lockstep.

    At each global step, slot d's next minibatch of its shard is row d of
    fixed-shape ``(world, B, …)`` uint8 codes (and mask), int32 labels
    and bool ``valid``.  A slot whose shard is exhausted, or that got no
    shard (a short last group), contributes an all-padding row with
    ``valid`` all False: it takes part in every collective and adds zero
    gradient, hits and rows.  Each shard's batches are the serial
    schedule's (the same ``iter_hashed_batches`` permutation).

    ``slot_range=(lo, hi)`` is a gang rank's window
    (``distributed.runtime.process_slot_range``): it reads only the
    shards of slots [lo, hi) of each group, and the stacked arrays carry
    those ``hi - lo`` rows.  The schedule stays global: ``n_rows`` counts
    the real examples of all slots (from ``counts``, no remote reads),
    each group takes the global ``max ceil(rows/B)`` steps, and
    ``Boundary.shards_consumed`` is the whole group.

    ``transfer(codes, empty|None, labels, valid) -> (args, ready)`` moves
    a step's arrays to the device.  ``start_pos`` must sit on a group
    boundary, the only place the trainer checkpoints.
    """
    slot_lo, slot_hi = (0, world) if slot_range is None else slot_range
    if not (0 <= slot_lo < slot_hi <= world):
        raise ValueError(
            f"slot_range {slot_range} outside the [0, {world}) slots")
    if start_pos % world != 0 and start_pos < n_shards:
        raise ValueError(
            f"data-parallel resume position {start_pos} is not a "
            f"multiple of the world size {world} — checkpoint written "
            "under a different schedule?")
    local = slot_hi - slot_lo
    for epoch in range(start_epoch, epochs):
        order = shard_order(seed, epoch, n_shards, shuffle)
        first = start_pos if epoch == start_epoch else 0
        for lo in range(first, n_shards, world):
            group = [int(s) for s in order[lo: lo + world]]
            iters = {d: iter_hashed_batches(
                root, batch_size, shard_ids=[group[d]],
                perm_seed=(seed, epoch), mmap=mmap)
                for d in range(len(group)) if slot_lo <= d < slot_hi}
            n_batches = [-(-counts[s] // batch_size) for s in group]
            for t in range(max(n_batches)):
                codes = np.zeros((local, batch_size, packed_width),
                                 np.uint8)
                empty = (np.zeros((local, batch_size, mask_width),
                                  np.uint8) if has_empty else None)
                labels = np.zeros((local, batch_size), np.int32)
                valid = np.zeros((local, batch_size), bool)
                for d, it in iters.items():
                    if t >= n_batches[d]:
                        continue
                    try:
                        bp, bl, _rid, bem = next(it)
                        _mask_consistent(bem, has_empty, group[d], root)
                    except StopIteration as e:
                        raise RuntimeError(
                            f"shard {group[d]} yielded fewer batches "
                            f"than its row count promised") from e
                    except Exception as e:
                        raise ShardStreamError(
                            f"shard {group[d]} (device slot {d}) failed "
                            f"at epoch {epoch} position {lo + d} of "
                            f"{root!r}: {e}", shard=group[d],
                            epoch=epoch, position=lo + d) from e
                    m = len(bl)
                    codes[d - slot_lo, :m] = bp
                    labels[d - slot_lo, :m] = bl
                    valid[d - slot_lo, :m] = True
                    if has_empty:
                        empty[d - slot_lo, :m] = bem
                # the global real rows of this step, a pure function of
                # the row counts, so every rank agrees without reads
                n_rows = sum(
                    min(batch_size, counts[group[d]] - t * batch_size)
                    for d in range(len(group)) if t < n_batches[d])
                args, ready = transfer(codes, empty, labels, valid)
                yield StreamBatch(args, n_rows, ready)
            next_epoch, next_pos = ((epoch, lo + world)
                                    if lo + world < n_shards
                                    else (epoch + 1, 0))
            yield Boundary(next_epoch, next_pos, len(group))


class ThreadedPrefetcher:
    """Runs an event generator in a bounded background (daemon) thread,
    up to ``depth`` items ahead of the consumer.  Iteration yields the
    generator's items in order; a producer exception re-raises at the
    same point in the consumer.  ``close()`` (idempotent) unblocks a
    producer stuck on a full queue and joins the thread."""

    def __init__(self, gen: Iterator[Any], depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._produce, args=(gen,), daemon=True,
            name="shard-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, gen) -> None:
        try:
            for item in gen:
                if not self._put(("item", item)):
                    return
            self._put(("done", None))
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            self._put(("error", e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            try:
                kind, val = self._q.get(timeout=0.25)
                break
            except queue.Empty:
                # a live producer always posts a sentinel in the end; a
                # dead thread with an empty queue never will
                if not self._thread.is_alive():
                    self._done = True
                    raise RuntimeError(
                        "prefetch producer thread died without "
                        "delivering an event or error sentinel — "
                        "the stream is lost") from None
        if kind == "item":
            return val
        self._done = True
        if kind == "error":
            raise val
        raise StopIteration

    def close(self) -> None:
        # exhausted first: a next() racing close must stop, not block on
        # a queue whose sentinel is drained below
        self._done = True
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # wake a consumer that entered get() just before close
        try:
            self._q.put_nowait(("done", None))
        except queue.Full:
            pass
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
