"""Deterministic sharded data loader with restart skip and prefetch (a
copy of ``repro/data/loader.py``: numpy only, the same batches for the
same (seed, epoch, shard, backup) and ``start_step``).

Production requirements served here:
  * host-sharded loading: worker (shard_id, num_shards) reads a disjoint
    row subset — the multi-host data-parallel input path;
  * deterministic global order: epoch shuffles are a pure function of
    (seed, epoch), so every host agrees without communication and a
    restarted job replays the exact same batches;
  * restart skip: ``start_step`` fast-forwards without touching data —
    checkpoint/resume yields bitwise-identical training (tested);
  * straggler hedging: ``backup_of`` lets a healthy worker double-read a
    slow worker's shard range (the classic backup-task mitigation);
  * background prefetch of the next batch (thread + queue).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


class HashedCodesLoader:
    """Iterates (codes uint16 (B,k), labels int32 (B,)) minibatches."""

    def __init__(
        self,
        codes: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        backup_of: Optional[int] = None,
        drop_remainder: bool = True,
    ):
        if codes.shape[0] != labels.shape[0]:
            raise ValueError("codes/labels row mismatch")
        self.codes = codes
        self.labels = labels
        self.batch_size = batch_size
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.backup_of = backup_of
        self.drop_remainder = drop_remainder

    # -- deterministic order ------------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, epoch)))
        order = rng.permutation(self.codes.shape[0])
        shards = [order[s:: self.num_shards] for s in range(self.num_shards)]
        mine = shards[self.shard_id]
        if self.backup_of is not None:
            # hedge: also cover the straggler's range (dedup at consumer)
            mine = np.concatenate([mine, shards[self.backup_of]])
        return mine

    def steps_per_epoch(self) -> int:
        n = self._epoch_order(0).shape[0]
        return n // self.batch_size if self.drop_remainder else (
            (n + self.batch_size - 1) // self.batch_size)

    def batches(
        self, start_step: int = 0, epochs: Optional[int] = None
    ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Yields (global_step, codes, labels) from ``start_step`` on."""
        spe = self.steps_per_epoch()
        step = start_step
        epoch = start_step // spe
        while epochs is None or epoch < epochs:
            order = self._epoch_order(epoch)
            local = step - epoch * spe
            for i in range(local, spe):
                sel = order[i * self.batch_size:(i + 1) * self.batch_size]
                yield step, self.codes[sel], self.labels[sel]
                step += 1
            epoch += 1

    def prefetching(self, *args, depth: int = 2, **kw):
        """Wraps ``batches`` with a background prefetch thread."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = object()

        def worker():
            try:
                for item in self.batches(*args, **kw):
                    q.put(item)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


class SparseRowsLoader:
    """Same contract over raw padded sparse rows (pre-hashing path)."""

    def __init__(self, indices: np.ndarray, nnz: np.ndarray,
                 labels: np.ndarray, batch_size: int, *, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1):
        self._inner = HashedCodesLoader(
            indices, labels, batch_size, seed=seed, shard_id=shard_id,
            num_shards=num_shards)
        self.nnz = nnz

    def batches(self, start_step: int = 0,
                epochs: Optional[int] = None):
        for step, idx, y in self._inner.batches(start_step, epochs):
            # recover row positions via the same order computation
            yield step, idx, self.nnz[
                self._row_ids(step)], y

    def _row_ids(self, step: int) -> np.ndarray:
        spe = self._inner.steps_per_epoch()
        epoch, local = divmod(step, spe)
        order = self._inner._epoch_order(epoch)
        bs = self._inner.batch_size
        return order[local * bs:(local + 1) * bs]
