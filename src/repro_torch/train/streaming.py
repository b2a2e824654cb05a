"""One-pass / multi-epoch streaming SGD over packed shard archives
(counterpart of ``repro/train/streaming.py``, serial arm).

  * ``fit_streaming`` iterates the archive one shard at a time through
    ``data.hashed_dataset.iter_hashed_batches``: minibatches sliced off
    mmap'd packed bytes; the (n, k) code matrix is never built;
  * minibatches go to the device packed, ceil(k·b/8) bytes a row, and
    stay packed into the forward: ``models.linear.bbit_logits_packed``,
    kernel B5 forward and B6 dW on the card (``kernels.ops``), with the
    ``oph_zero`` packed empty mask when the archive has one;
  * **prefetch** (``prefetch`` ≥ 1, the default 2): host batch work —
    mmap fault-in, shuffle, slice, the copy to the card from pinned
    memory on a side stream — runs in a bounded producer thread
    (``data.prefetch``).  The step's stream waits on each batch's copy
    event.  Results are bit-identical to the inline path
    (``prefetch=0``) and checkpoints interchange across depths;
  * the update is SGD/AdamW (``optim.optimizers``) with Polyak tail
    averaging (``optim.averaging``) through
    ``train.steps.build_averaged_train_step``;
  * **progressive validation**: every example is scored by the model
    before its gradient step; the hit counts stay on the device and are
    read once per shard, so no step waits for the host;
  * shard order and each shard's rows are permuted every epoch as pure
    functions of ``(seed, epoch, shard)`` (``data.prefetch.shard_order``),
    so a restarted run replays identical batches;
  * ``ckpt_dir`` checkpoints the whole ``AveragedTrainState``, the stream
    position and the counters at shard boundaries (``ckpt.checkpoint``),
    and publishes the eval params under ``<ckpt_dir>/serve``; a killed
    run resumes at the boundary and ends bit-identical to an
    uninterrupted one.  ``train.supervisor`` restarts crashed runs;
  * **data parallelism** (``data_parallel=N``): the epoch's shard order
    is split into consecutive groups of N, one shard a slot
    (``data.prefetch.group_batch_stream``), and the step is
    ``train.data_parallel``'s: each slot's gradient sum, two collectives,
    the scale after the reduction.  Uneven groups are safe: a slot with
    fewer batches, or no shard, contributes padding rows of weight zero.
    The fingerprint records the LOGICAL world and the slot policy; the
    physical device count rides a lineage record instead;
  * **elastic** (``elastic=True``): the N logical slots fold onto the
    devices that are alive (``ckpt.elastic``; a restored tree lands on
    the mesh's first device, its template's), and a checkpoint written
    on another topology, another gang size included, resumes by adopting
    its logical schedule; each realization (logical, physical, procs) is
    appended to the topology lineage in every checkpoint's meta.json and
    on the result;
  * **gangs** (a ``distributed.runtime`` with ``procs > 1``): each rank
    streams only its contiguous block of slots while the step count and
    boundaries stay global, the two collectives span the gang, every
    rank writes a heartbeat at each boundary, and checkpoints are
    coordinated (``ckpt.coordinated``);
  * ``grad_compress`` (8 or 1, data-parallel only) swaps the exact
    gradient all-reduce for error-feedback int8 or sign+scale
    (``distributed.grad_compression``); it changes the numerics, so it is
    in the fingerprint, and its residuals are not checkpointed (a resume
    starts them at zero).

    stats = preprocess_and_save(root, rows, labels, k=256, b=8,
                                scheme="oph", n_shards=8)
    res = fit_streaming(root, BBitLinearConfig(k=256, b=8),
                        epochs=1, batch_size=1024,
                        ckpt_dir=root + "/ckpt")
    w = res.eval_params            # Polyak average (or raw iterate)
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import coordinated
from repro_torch.ckpt.elastic import (mesh_from_available_devices,
                                      physical_data_world, process_fold)
from repro_torch.core.bbit import packed_mask_width, packed_width
from repro_torch.data.hashed_dataset import (_read_meta, _to_device,
                                             shard_row_counts)
from repro_torch.data.prefetch import (Boundary, StreamBatch,
                                       ThreadedPrefetcher,
                                       group_batch_stream,
                                       serial_batch_stream, shard_order)
from repro_torch.devices import DeviceLike, resolve_device, visible_devices
from repro_torch.distributed.runtime import (
    SHARD_OWNERSHIP, ProcessRuntime, current_runtime, heartbeat,
    mesh_over_processes, process_devices, process_slot_range,
    replicate_across_processes)
from repro_torch.ft import faults
from repro_torch import perf
from repro_torch.models.linear import (BBitLinearConfig, bbit_logits_packed,
                                       logits_packed_impl)
from repro_torch.optim.averaging import average_or_none
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train import linear_trainer
from repro_torch.train.data_parallel import (build_dp_averaged_train_step,
                                             init_dp_error_state)
from repro_torch.train.losses import (mean_loss_with_preds_fn,
                                      sum_loss_with_hits_fn)
from repro_torch.train.steps import (build_averaged_train_step,
                                     init_averaged_state)


@dataclasses.dataclass
class StreamFitResult:
    params: Any                    # final SGD iterate
    avg_params: Optional[Any]      # Polyak tail average (None if unused)
    train_seconds: float
    progressive_acc: float         # one-pass accuracy, VW-style
    n_steps: int
    examples_seen: int
    shards_processed: int          # cumulative, survives resume
    completed: bool                # False when stop_after_shards hit
    # every (logical, physical, procs) realization this run trained
    # under, oldest first, also in each checkpoint's meta.json
    topology_lineage: list = dataclasses.field(default_factory=list)
    # what the cost model chose for the packed logits and which profile
    # it read, also in each checkpoint's meta.json extras; not in the
    # replay fingerprint (a profile swap must not invalidate a resume)
    dispatch: Optional[dict] = None

    @property
    def eval_params(self) -> Any:
        """The params to evaluate or serve: the averaged iterate when tail
        averaging ran, else the raw final iterate."""
        return self.avg_params if self.avg_params is not None else self.params


def _planned_steps(counts, batch_size: int, *, epochs: int, seed: int,
                   shuffle: bool, world: int) -> int:
    """Train steps of the whole run.  A group of ``world`` shards runs
    in lockstep for its longest member, max_d ceil(rows_d/B) steps, and
    the groups follow each epoch's shard shuffle; ``world=1`` is the
    serial Σ_shards ceil(rows/B)."""
    n_shards = len(counts)
    ceil = [-(-c // batch_size) for c in counts]
    if world == 1:
        return epochs * sum(ceil)
    total = 0
    for epoch in range(epochs):
        order = shard_order(seed, epoch, n_shards, shuffle)
        for lo in range(0, n_shards, world):
            total += max(ceil[int(s)] for s in order[lo: lo + world])
    return total


def _batch_tensors(args: tuple):
    out = []
    for a in args:
        out.extend(a if isinstance(a, tuple) else (a,))
    return out


def fit_streaming(
    root: str,
    cfg: BBitLinearConfig,
    *,
    loss: str = "logistic",
    optimizer: str = "adamw",
    lr: float = 1e-2,
    l2: float = 1e-6,
    epochs: int = 1,
    batch_size: int = 256,
    seed: int = 0,
    average: bool = True,
    avg_start_frac: float = 0.5,
    shuffle_shards: bool = True,
    mmap: bool = True,
    prefetch: int = 2,
    data_parallel: Optional[int] = None,
    elastic: bool = False,
    ckpt_dir: Optional[str] = None,
    ckpt_every_shards: int = 1,
    ckpt_keep_last: int = 3,
    resume: bool = True,
    stop_after_shards: Optional[int] = None,
    watchdog: Optional[Any] = None,
    runtime: Optional[ProcessRuntime] = None,
    grad_compress: Optional[int] = None,
    ckpt_barrier_timeout_s: float = 120.0,
    moment_dtype: str = "float32",
    device: DeviceLike = None,
) -> StreamFitResult:
    """Streams a format-v1..v4 hashed archive through minibatch SGD on
    ``device`` (default ``cuda:0``; ``"cpu"`` runs the kernels' plain
    versions).

    ``prefetch`` is the pipeline depth (0: inline; results are
    bit-identical either way).  ``watchdog`` (``ft.watchdog
    .StepWatchdog``) observes each step's host latency.
    ``ckpt_keep_last`` sizes the checkpoint ring.  ``avg_start_frac``
    opens the Polyak window after that fraction of the planned steps
    (ignored when ``average=False``).  ``stop_after_shards`` (requires
    ``ckpt_dir``) processes at most that many shards in this call,
    checkpoints and returns ``completed=False``; a call with the same
    arguments continues.  Resume requires the same archive and
    hyperparameters (a fingerprint of them is checkpointed).

    ``data_parallel=N`` is the LOGICAL world: N shard slots a step.
    Without ``elastic`` it must fit the visible devices and a resume on
    another topology refuses; with ``elastic=True`` the slots fold onto
    the devices there are (``stop_after_shards`` then rounds up to whole
    groups).  Under a gang's runtime (``runtime``, default
    ``distributed.runtime.current_runtime()``) the slots split into one
    contiguous block a rank, on the rank's devices, and checkpoints are
    coordinated (``ckpt_barrier_timeout_s`` bounds rank 0's wait for the
    payloads).  ``grad_compress`` (8 or 1) compresses the gradient
    exchange.  ``moment_dtype`` (``"bfloat16"`` or ``"int8"``, AdamW
    only; not an argument of the reference's trainer) stores AdamW's
    moments narrow (``optim.quantized_state``).
    """
    meta = _read_meta(root)
    if meta.get("shards", 0) <= 0 or meta.get("n", 0) <= 0:
        raise ValueError(
            f"cannot stream-train on an empty archive at {root!r} "
            f"(n={meta.get('n')}, shards={meta.get('shards')})")
    k, b = meta["k"], meta["b"]
    if (cfg.k, cfg.b) != (k, b):
        raise ValueError(
            f"config (k={cfg.k}, b={cfg.b}) does not match archive "
            f"(k={k}, b={b})")
    if epochs < 1 or batch_size < 1 or ckpt_every_shards < 1:
        raise ValueError(
            "epochs, batch_size and ckpt_every_shards must be >= 1")
    if prefetch < 0:
        raise ValueError(f"prefetch depth must be >= 0, got {prefetch}")
    if cfg.n_classes != 2 and loss != "softmax":
        raise ValueError(
            f"loss={loss!r} is binary-only; multiclass streaming "
            "(n_classes > 2) requires loss='softmax'")
    if cfg.n_classes == 2 and loss == "softmax":
        # a single-logit softmax has zero loss: untrained params
        raise ValueError(
            "loss='softmax' needs n_classes > 2; binary configs use a "
            "margin loss ('logistic', 'hinge', 'squared_hinge')")
    if stop_after_shards is not None and not ckpt_dir:
        raise ValueError(
            "stop_after_shards without ckpt_dir would discard the "
            "partial run — a repeat call could only restart from "
            "scratch, never continue")

    counts = shard_row_counts(root)
    n_shards = len(counts)
    small = [i for i, c in enumerate(counts) if 0 < c < batch_size]
    if small:
        raise ValueError(
            f"batch_size={batch_size} exceeds the {min(counts[i] for i in small)}"
            f" rows of shard(s) {small[:4]}{'…' if len(small) > 4 else ''}"
            f" in {root!r} — lower batch_size or re-shard the archive "
            "with fewer shards")

    # data_parallel names the LOGICAL schedule; the devices and the step
    # follow a possible adoption of a checkpoint's schedule below
    dp = data_parallel is not None
    logical = int(data_parallel) if dp else 1
    rt = runtime if runtime is not None else (current_runtime()
                                              or ProcessRuntime())
    procs = rt.procs
    if procs > 1:
        if not dp:
            raise ValueError(
                f"a {procs}-process gang requires data_parallel — the "
                "serial schedule has no shard slots to split across "
                "processes")
        # logical % procs up front: stream, mesh and checkpoints all
        # assume even contiguous blocks
        process_slot_range(logical, procs, rt.rank)
        if rt.backend is None:
            raise ValueError(
                f"a {procs}-process runtime needs a process group: "
                "join the gang with distributed.runtime.init_runtime")
    if grad_compress is not None:
        if not dp:
            raise ValueError(
                "grad_compress applies to the data-parallel gradient "
                "all-reduce — pass data_parallel")
        if grad_compress not in (1, 8):
            raise ValueError(
                f"grad_compress must be 8 (int8 blockwise) or 1 "
                f"(sign+scale), got {grad_compress}")
    compress = (None if grad_compress is None
                else {"bits": int(grad_compress), "block": 256})

    # oph_zero archives carry a packed empty bitmask; batches then travel
    # as (codes bytes, mask bytes).  v3+ answers from the filesystem,
    # older formats from the recorded scheme
    if meta["format_version"] >= 3:
        has_empty = os.path.exists(
            os.path.join(root, "hashed_00000.empty.npy"))
    else:
        has_empty = meta.get("scheme") == "oph_zero"

    def fwd(params, batch):
        if has_empty:
            pk, em = batch
            return bbit_logits_packed(params, pk, cfg, empty_packed=em)
        return bbit_logits_packed(params, batch, cfg)

    # the rank's first device in a group, else the caller's
    dev = (process_devices(device, rt.rank, rt.local_devices)[0]
           if rt.backend is not None else resolve_device(device))
    opt = make_optimizer(optimizer, lr, moment_dtype=moment_dtype)
    astate = init_averaged_state(
        linear_trainer._initial_params(cfg, seed, dev), opt)
    epoch0, pos0, shards_done, hits, seen = 0, 0, 0, 0, 0
    if (ckpt_dir and not resume
            and ckpt.latest_step(ckpt_dir) is not None):
        # a fresh run's low step numbers would be pruned under the old
        # run's, and a later resume would pick up the stale run
        raise ValueError(
            f"ckpt_dir {ckpt_dir!r} already holds checkpoints (latest "
            f"step {ckpt.latest_step(ckpt_dir)}); with resume=False "
            "point at a fresh directory or delete the old run first")
    restored_tree = None
    restored_step = None
    prior_lineage: list = []
    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        template = {"astate": astate, "epoch": np.int64(0),
                    "pos": np.int64(0), "shards_done": np.int64(0),
                    "hits": np.int64(0), "seen": np.int64(0),
                    "fingerprint": np.int64(0)}
        try:
            restored_tree, restored_step = ckpt.restore(ckpt_dir,
                                                        template)
        except FileNotFoundError:
            # every retained checkpoint failed validation and was
            # quarantined: the only honest continuation is a fresh start
            restored_tree = None
        except ValueError as e:
            raise ValueError(
                f"checkpoint under {ckpt_dir!r} is incompatible with "
                "this run's model/optimizer state (resume requires the "
                f"same archive and hyperparameters): {e}") from e
    if restored_tree is not None:
        smeta = ckpt.load_meta(ckpt_dir, restored_step) or {}
        sched = smeta.get("schedule")
        if sched is not None:
            ck_dp = bool(sched.get("dp"))
            ck_logical = int(sched.get("logical_world", 1))
            ck_procs = int(sched.get("procs", 1))
            if ck_procs != procs and not elastic:
                raise ValueError(
                    f"checkpoint under {ckpt_dir!r} was written by a "
                    f"{ck_procs}-process gang but this run has {procs} "
                    "process(es) — pass elastic=True to resume across "
                    "gang sizes")
            if (ck_dp, ck_logical) != (dp, logical):
                if not elastic:
                    raise ValueError(
                        f"checkpoint under {ckpt_dir!r} is incompatible:"
                        " it was written under "
                        + (f"data_parallel={ck_logical}" if ck_dp
                           else "the serial schedule")
                        + " but this run requested "
                        + (f"data_parallel={logical}" if dp
                           else "the serial schedule")
                        + " — pass elastic=True to adopt the "
                        "checkpoint's logical schedule on the current "
                        "devices")
                dp, logical = ck_dp, ck_logical
        prior_lineage = list(smeta.get("lineage", []))

    total_steps = _planned_steps(counts, batch_size, epochs=epochs,
                                 seed=seed, shuffle=shuffle_shards,
                                 world=logical)
    avg_start_step = (int(math.floor(avg_start_frac * total_steps))
                      if average else total_steps + 1)

    # everything replay depends on, the reference's payload; prefetch
    # depth is left out on purpose (it never changes the step sequence),
    # and so are the physical devices and the gang size (the fold makes
    # the update a function of the logical schedule; they ride the
    # lineage record instead)
    payload = {
        "archive": {"n": meta["n"], "shards": n_shards, "k": k, "b": b,
                    "scheme": meta.get("scheme"), "seed": meta.get("seed")},
        "cfg": dataclasses.asdict(cfg),
        "loss": loss, "optimizer": optimizer, "lr": lr, "l2": l2,
        "epochs": epochs, "batch_size": batch_size, "seed": seed,
        "average": average, "avg_start_step": avg_start_step,
        "shuffle_shards": shuffle_shards,
        "world": logical,
        "shard_assignment": ("contiguous_groups" if dp else "serial"),
        "process_topology": {"shard_ownership": SHARD_OWNERSHIP},
        "grad_compress": int(grad_compress) if grad_compress else None}
    if moment_dtype != "float32":
        payload["moment_dtype"] = moment_dtype
    fingerprint = ckpt.run_fingerprint(payload)

    # the packed logits' arm, chosen once up front: the run's dispatch of
    # record in checkpoints and on the result, kept out of the fingerprint
    chosen_impl = logits_packed_impl(cfg, rows=batch_size, device=dev)
    _perf_rep = perf.dispatch_report()
    dispatch_record = {"logits_packed": chosen_impl,
                       "table_version": _perf_rep["table_version"],
                       "profile_loaded": _perf_rep["profile_loaded"]}

    if restored_tree is not None:
        if int(restored_tree["fingerprint"]) != int(fingerprint):
            raise ValueError(
                f"checkpoint under {ckpt_dir!r} is incompatible: it was "
                "written by a run with different hyperparameters, a "
                "different archive, or a different data-parallel "
                "topology (fingerprint mismatch) — resume requires "
                "identical settings")
        astate = restored_tree["astate"]
        epoch0 = int(restored_tree["epoch"])
        pos0 = int(restored_tree["pos"])
        shards_done = int(restored_tree["shards_done"])
        hits = int(restored_tree["hits"])
        seen = int(restored_tree["seen"])

    if dp:
        if rt.backend is not None:
            # logical slots → a contiguous block a rank → a fold a device
            _, d_local, physical = process_fold(
                logical, procs, rt.local_devices, elastic=elastic)
            mesh = mesh_over_processes(d_local, rt, device)
        else:
            n_dev = visible_devices(dev)
            if not elastic and logical > n_dev:
                raise ValueError(
                    f"data_parallel={logical} needs {logical} devices "
                    f"but only {n_dev} are visible — pass elastic=True "
                    "to fold the logical shard slots onto the "
                    "available devices")
            physical = (physical_data_world(logical, n_dev) if elastic
                        else logical)
            mesh = mesh_from_available_devices(max_devices=physical,
                                               device=dev)
        # the state (restored onto the mesh's first device, the
        # template's) replicated: every rank's made rank 0's
        astate = replicate_across_processes(astate, mesh)
        n_devices = (procs * rt.local_devices if rt.backend is not None
                     else visible_devices(dev))
    else:
        physical, n_devices = 1, visible_devices(dev)

    # the topology lineage: every (logical, physical, procs) realization
    # of this run, appended on change, in each checkpoint's meta.json
    lineage = list(prior_lineage)
    realization = {"logical": int(logical), "physical": int(physical),
                   "procs": int(procs), "devices": int(n_devices),
                   "from_step": int(shards_done)}
    if not lineage or any(lineage[-1].get(key) != realization[key]
                          for key in ("logical", "physical", "procs")):
        lineage.append(realization)

    err0 = None
    if dp:
        step_fn = build_dp_averaged_train_step(
            sum_loss_with_hits_fn(fwd, loss), opt, mesh, l2=l2,
            logical_world=logical, compress=compress)
        if compress is not None:
            # each local device's residual, reset on every (re)start
            err0 = init_dp_error_state(astate.state.params, mesh.local)
    else:
        loss_with_preds = mean_loss_with_preds_fn(fwd, loss, l2=l2)

        def loss_and_hits(params, batch, labels):
            total, pred = loss_with_preds(params, batch, labels)
            return total, torch.sum(pred == labels)

        step_fn = build_averaged_train_step(loss_and_hits, opt,
                                            has_aux=True)

    def save_boundary(next_epoch: int, next_pos: int) -> None:
        tree = {"astate": astate, "epoch": np.int64(next_epoch),
                "pos": np.int64(next_pos),
                "shards_done": np.int64(shards_done),
                "hits": np.int64(hits), "seen": np.int64(seen),
                "fingerprint": fingerprint}
        extra = {"schedule": {"dp": dp, "logical_world": int(logical),
                              "procs": int(procs)},
                 "lineage": lineage,
                 "dispatch": dispatch_record}
        if procs > 1:
            # every rank writes its CRC'd payload; rank 0 commits the
            # step once all have landed
            coordinated.save_coordinated(
                ckpt_dir, shards_done, tree, rank=rt.rank, procs=procs,
                keep_last=ckpt_keep_last,
                barrier_timeout_s=ckpt_barrier_timeout_s,
                extra_meta=extra)
            if not rt.is_leader:
                return
        else:
            ckpt.save(ckpt_dir, shards_done, tree,
                      keep_last=ckpt_keep_last, extra_meta=extra)
        # the eval iterate (the Polyak average once its window opened),
        # params only, for a server's reload (rank 0's in a gang)
        serve_now = (astate.avg_params if float(astate.avg_count) > 0
                     else astate.state.params)
        ckpt.publish_params(ckpt_dir, shards_done, serve_now)

    # batches to the device: on a card from pinned memory on a side
    # stream, with an event the step's stream waits on
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def to_dev(codes, empty, *rest):
        """(batch, *rest) on the device; the copy event (None on the
        CPU)."""
        arrays = (codes, *rest) if empty is None else (codes, empty, *rest)
        with torch.cuda.stream(side):          # no-op on the CPU
            ts = [_to_device(np.ascontiguousarray(a), dev)
                  for a in arrays]
            ready = None if side is None else side.record_event()
        batch = ts[0] if empty is None else (ts[0], ts[1])
        return (batch, *ts[len(ts) - len(rest):]), ready

    if dp:
        # a rank streams only its block of slots; every rank keeps the
        # global step count and boundaries
        stream = group_batch_stream(
            root, batch_size, seed=seed, epochs=epochs, n_shards=n_shards,
            counts=counts, world=logical, shuffle=shuffle_shards,
            start_epoch=epoch0, start_pos=pos0, has_empty=has_empty,
            packed_width=packed_width(k, b),
            mask_width=packed_mask_width(k), transfer=to_dev, mmap=mmap,
            slot_range=(process_slot_range(logical, procs, rt.rank)
                        if procs > 1 else None))
    else:
        stream = serial_batch_stream(
            root, batch_size, seed=seed, epochs=epochs, n_shards=n_shards,
            shuffle=shuffle_shards, start_epoch=epoch0, start_pos=pos0,
            has_empty=has_empty, transfer=to_dev, mmap=mmap)
    events = ThreadedPrefetcher(stream, prefetch) if prefetch else stream

    global_step = int(astate.state.step)
    processed_here = 0
    stopped = False
    pending_hits = []
    t0 = time.perf_counter()
    try:
        for ev in events:
            if isinstance(ev, StreamBatch):
                if ev.ready is not None:
                    cur = torch.cuda.current_stream(dev)
                    cur.wait_event(ev.ready)
                    for t in _batch_tensors(ev.args):
                        t.record_stream(cur)
                active = np.float32(global_step >= avg_start_step)
                if watchdog is not None:
                    watchdog.start_step()
                # inside the watchdog window: an injected slow step shows
                # as step latency, an injected crash dies mid-step
                if faults._ACTIVE is not None:
                    faults.on_train_step(global_step)
                if compress is not None:
                    (astate, err0), (_, h) = step_fn(
                        (astate, err0), active, *ev.args)
                else:
                    astate, (_, h) = step_fn(astate, active, *ev.args)
                if watchdog is not None:
                    # the host's step latency (enqueue + any producer
                    # stall), where injected slow steps and starving
                    # input pipelines show
                    watchdog.end_step(global_step)
                pending_hits.append(h)
                seen += ev.n_rows
                global_step += 1
                continue
            assert isinstance(ev, Boundary)
            if pending_hits:
                # the one read back of a shard
                hits += int(torch.stack(pending_hits).sum())
                pending_hits = []
            prev_done = shards_done
            shards_done += ev.shards_consumed
            processed_here += ev.shards_consumed
            if rt.is_multiprocess:
                heartbeat(rt, step=global_step, shards_done=shards_done)
            at_stop = (stop_after_shards is not None
                       and processed_here >= stop_after_shards)
            done = ev.next_epoch >= epochs
            crossed = (shards_done // ckpt_every_shards
                       > prev_done // ckpt_every_shards)
            if ckpt_dir and (crossed or at_stop or done):
                save_boundary(ev.next_epoch, ev.next_pos)
            if at_stop and not done:
                stopped = True
                break
    finally:
        # joins the producer thread; a plain generator's close drops its
        # open mmap'd shard now
        events.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    if not (stopped or global_step > 0):
        raise RuntimeError("streaming run performed no steps")
    return StreamFitResult(
        params=astate.state.params,
        avg_params=average_or_none(astate.avg_params, astate.avg_count),
        train_seconds=dt,
        progressive_acc=hits / max(seen, 1),
        n_steps=global_step,
        examples_seen=seen,
        shards_processed=shards_done,
        completed=not stopped,
        topology_lineage=lineage,
        dispatch=dispatch_record,
    )
