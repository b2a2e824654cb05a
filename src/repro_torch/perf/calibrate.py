"""One-shot microbenchmark calibration for the dispatch cost model
(counterpart of ``repro/perf/calibrate.py``).

Protocol (``docs/DESIGN.md`` §2.3): for every (op, shape) in a small
deterministic grid, each eligible arm is pinned with ``perf.forced`` and
timed through the *real* wrappers (the scheme's encodes, the model's
logits, ``ops.hamming_topk``) with one untimed warm-up call (it also
builds and loads the kernels) followed by the median of ``trials``
timed calls.  On the card a call is timed with CUDA events recorded
around it on the current stream; on the CPU with the host clock.  On the
card the eligible arm is the kernel (the plain arm only where no kernel
applies); on the CPU it is the plain version.  A global wall-clock
``budget_s`` is checked between measurements: when it runs out the
table is returned as it is, and ``choose`` keeps the static rule for any
bucket without a measured arm, so partial profiles are safe.

``serve_score`` is the serving engine's whole pass (encode and pack,
then the packed scores) over the (row bucket × nnz lane) grid: the cost
curve ``perf.suggest_row_buckets`` / ``suggest_lane_caps`` read.  At
each point of that grid the pass's two ops (``encode_packed``,
``logits_packed``) are timed too, so the engine's own dispatches find
their shapes in the profile.

Trial inputs are derived from a fixed seed so two calibration runs on
the same box produce comparable tables.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.perf import cost_model
from repro_torch.perf.cost_model import OPS, CostTable, device_fingerprint


class _Budget:
    def __init__(self, budget_s: float):
        self._t0 = time.perf_counter()
        self._budget = float(budget_s)

    def spent(self) -> float:
        return time.perf_counter() - self._t0

    def exhausted(self) -> bool:
        return self.spent() >= self._budget


def _seconds(fn: Callable[[], object], dev: torch.device) -> float:
    """One call of ``fn``: CUDA events around it on the card, the host
    clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _median_time(fn, trials: int, budget: _Budget,
                 dev: torch.device) -> Optional[float]:
    """One warm-up (kernel build and load, untimed) + up to ``trials``
    timed calls; returns the median, or None if there was no room for
    even the warm-up."""
    if budget.exhausted():
        return None
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    samples = []
    for _ in range(max(1, trials)):
        if samples and budget.exhausted():
            break
        samples.append(_seconds(fn, dev))
    return float(np.median(samples)) if samples else None


# ---------------------------------------------------------------------------
# deterministic trial inputs


def _sparse_rows(rng: np.random.Generator, rows: int, width: int,
                 dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = rng.integers(0, 1 << 30, size=(rows, width)).astype(np.int32)
    nnz = rng.integers(max(1, width // 2), width + 1,
                       size=(rows,)).astype(np.int32)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(nnz).to(dev)


def _params(k: int, b: int, seed: int, dev: torch.device):
    from repro_torch.models.linear import BBitLinearConfig, init_bbit_linear
    cfg = BBitLinearConfig(k=k, b=b)
    gen = torch.Generator().manual_seed(seed)
    return cfg, init_bbit_linear(cfg, gen, device=dev)


def _time_arms(table: CostTable, op: str, shape: dict, dev: torch.device,
               fn: Callable[[], object], trials: int,
               budget: _Budget) -> None:
    """Times ``fn`` with ``op`` pinned to each arm eligible at ``shape``
    on ``dev``, and records each."""
    for impl in OPS[op].eligible(shape, dev):
        with cost_model.forced(**{op: impl}):
            sec = _median_time(fn, trials, budget, dev)
        if sec is not None:
            table.put(op, impl, shape, sec)


def _measure_encode(table: CostTable, *, scheme: str, k: int, b: int,
                    rows: int, width: int, trials: int, budget: _Budget,
                    seed: int, packed: bool, dev: torch.device) -> None:
    from repro_torch.core.schemes import make_scheme
    op = "encode_packed" if packed else "encode"
    sch = make_scheme(scheme, k, seed)
    rng = np.random.default_rng(seed * 7919 + rows * 31 + width)
    idx, nnz = _sparse_rows(rng, rows, width, dev)
    shape = {"scheme": scheme, "k": k, "b": b, "rows": rows, "nnz": width}
    enc = sch.encode_packed if packed else sch.encode_device
    _time_arms(table, op, shape, dev, lambda: enc(idx, nnz, b), trials,
               budget)


def _measure_logits(table: CostTable, *, k: int, b: int, rows: int,
                    trials: int, budget: _Budget, seed: int,
                    packed: bool, dev: torch.device) -> None:
    from repro_torch.core.bbit import pack_codes
    from repro_torch.models.linear import bbit_logits, bbit_logits_packed
    op = "logits_packed" if packed else "logits"
    v = 1 << b
    cfg, params = _params(k, b, seed, dev)
    rng = np.random.default_rng(seed * 104729 + rows * 13 + b)
    codes = rng.integers(0, v, size=(rows, k)).astype(np.uint16)
    shape = {"k": k, "b": b, "v": v, "rows": rows}
    if packed:
        x = torch.from_numpy(pack_codes(codes, b)).to(dev)
        fn = lambda: bbit_logits_packed(params, x, cfg)  # noqa: E731
    else:
        x = torch.from_numpy(codes.astype(np.int32)).to(dev)
        fn = lambda: bbit_logits(params, x, cfg)  # noqa: E731
    with torch.no_grad():
        _time_arms(table, op, shape, dev, fn, trials, budget)


def _measure_hamming(table: CostTable, *, k: int, b: int, rows: int,
                     trials: int, budget: _Budget, seed: int,
                     dev: torch.device) -> None:
    from repro_torch.core.bbit import packed_width
    from repro_torch.kernels import ops
    width = packed_width(k, b)
    rng = np.random.default_rng(seed * 7 + rows)
    cands = torch.from_numpy(rng.integers(0, 256, size=(rows, width),
                                          dtype=np.uint8)).to(dev)
    query = cands[0].clone()
    shape = {"b": b, "k": k, "rows": rows, "width": width}
    _time_arms(table, "hamming_topk", shape, dev,
               lambda: ops.hamming_topk(query, cands, k=k, bits=b, topk=10),
               trials, budget)


def _measure_serve_score(table: CostTable, *, scheme: str, k: int, b: int,
                         max_batch: int, nnz_buckets: Sequence[int],
                         trials: int, budget: _Budget, seed: int,
                         dev: torch.device) -> None:
    """Cost-per-dispatch curve of the serving engine's pass (encode and
    pack, then packed scores) over the (row bucket × nnz lane) grid,
    and at each point its two ops' eligible arms."""
    from repro_torch.core.schemes import make_scheme
    from repro_torch.models.linear import bbit_scores_packed
    sch = make_scheme(scheme, k, seed)
    cfg, params = _params(k, b, seed, dev)

    def score(idx, nnz):
        packed, empty = sch.encode_packed(idx, nnz, b)
        return bbit_scores_packed(params, packed, cfg, empty_packed=empty)

    rng = np.random.default_rng(seed * 613 + k)
    with torch.no_grad():
        for m in nnz_buckets:
            for rows in cost_model._pow2_candidates(max_batch):
                if budget.exhausted():
                    return
                idx, nnz = _sparse_rows(rng, rows, int(m), dev)
                sec = _median_time(lambda: score(idx, nnz), trials, budget,
                                   dev)
                if sec is not None:
                    table.put("serve_score", "fused",
                              {"scheme": scheme, "k": k, "b": b,
                               "rows": rows, "nnz": int(m)}, sec)
                enc_shape = {"scheme": scheme, "k": k, "b": b,
                             "rows": rows, "nnz": int(m)}
                _time_arms(table, "encode_packed", enc_shape, dev,
                           lambda: sch.encode_packed(idx, nnz, b), trials,
                           budget)
                packed, empty = sch.encode_packed(idx, nnz, b)
                _time_arms(table, "logits_packed",
                           {"k": k, "b": b, "v": 1 << b, "rows": rows},
                           dev,
                           lambda: bbit_scores_packed(
                               params, packed, cfg, empty_packed=empty),
                           trials, budget)


# ---------------------------------------------------------------------------


def calibrate(*, k: int = 256, b_values: Iterable[int] = (8,),
              schemes: Iterable[str] = ("oph",),
              encode_rows: Iterable[int] = (64, 256),
              encode_widths: Iterable[int] = (256, 1024),
              logits_rows: Iterable[int] = (256, 1024),
              max_batch: int = 64,
              nnz_buckets: Sequence[int] = (128, 512, 2048),
              include_serving: bool = True,
              trials: int = 3, budget_s: float = 60.0,
              seed: int = 0,
              table_version: str = "v1",
              device: DeviceLike = None) -> CostTable:
    """Populate a :class:`CostTable` for this box within a wall-clock
    budget, timing on ``device`` (default ``cuda:0``).  Shapes are
    visited cheapest-first so a tight budget still yields complete
    entries for the small buckets."""
    dev = resolve_device(device)
    schemes = tuple(schemes)
    b_values = tuple(int(b) for b in b_values)
    budget = _Budget(budget_s)
    table = CostTable(fingerprint=device_fingerprint(),
                      table_version=table_version,
                      meta={"budget_s": float(budget_s),
                            "trials": int(trials), "seed": int(seed),
                            "k": int(k), "schemes": list(schemes),
                            "b_values": list(b_values),
                            "device": str(dev)})
    for b in b_values:
        for rows in sorted(encode_rows):
            for width in sorted(encode_widths):
                for scheme in schemes:
                    if budget.exhausted():
                        break
                    for packed in (True, False):
                        _measure_encode(table, scheme=scheme, k=k, b=b,
                                        rows=rows, width=width,
                                        trials=trials, budget=budget,
                                        seed=seed, packed=packed, dev=dev)
        for rows in sorted(logits_rows):
            if budget.exhausted():
                break
            for packed in (True, False):
                _measure_logits(table, k=k, b=b, rows=rows, trials=trials,
                                budget=budget, seed=seed, packed=packed,
                                dev=dev)
            _measure_hamming(table, k=k, b=b, rows=rows, trials=trials,
                             budget=budget, seed=seed, dev=dev)
        if include_serving and not budget.exhausted():
            for scheme in schemes:
                _measure_serve_score(table, scheme=scheme, k=k, b=b,
                                     max_batch=max_batch,
                                     nnz_buckets=nnz_buckets,
                                     trials=trials, budget=budget,
                                     seed=seed, dev=dev)
    table.meta["calibrate_seconds"] = round(budget.spent(), 3)
    table.meta["n_entries"] = len(table.entries)
    return table


def summarize(table: CostTable) -> Dict[str, object]:
    """Digest: entries per op and, for each (op, bucket), the arm the
    profile picks there (with the port's one eligible arm a shape, the
    measured one)."""
    per_op: Dict[str, int] = {}
    picks: Dict[str, Dict[str, str]] = {}
    by_bucket: Dict[Tuple[str, str], Dict[str, float]] = {}
    for key, sec in table.entries.items():
        op, impl, bucket = key.split("|", 2)
        per_op[op] = per_op.get(op, 0) + 1
        by_bucket.setdefault((op, bucket), {})[impl] = sec
    for (op, bucket), costs in sorted(by_bucket.items()):
        if op != "serve_score":
            picks.setdefault(op, {})[bucket] = min(costs, key=costs.get)
    return {"table_version": table.table_version,
            "fingerprint": table.fingerprint,
            "entries": len(table.entries), "per_op": per_op,
            "profile_picks": picks, "meta": table.meta}
