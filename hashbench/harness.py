"""One run of one cell: set-up, the timed window, the check, the result.

The cell's files are found by the names in BENCHMARK.json: the
configuration's ``file``, ``traffic/<traffic>.json`` (whose ``loop``
names ``loops/<loop>.py``), ``checks/<workload>.json`` (what the
check compares, and each number's limit), and one reader
``metrics/<metric>.py`` for each per-layer metric of the cell.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that must not be loaded in a run: JAX and the JAX
# package (compared by whole top-level names: repro_torch is not repro)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, rehearsal: bool = False) -> Cell:
    """The cell ``name`` of BENCHMARK.json and its files.  With
    ``rehearsal`` each file's ``rehearsal`` keys replace its own (a
    small size, for the CPU)."""
    bench = _read(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    parts = {"config": _read(ROOT / conf["file"]),
             "traffic": _read(HERE / "traffic" / f"{w['traffic']}.json"),
             "check": _read(HERE / "checks" / f"{name}.json")}
    if rehearsal:
        parts = {k: dict(p, **p.get("rehearsal", {}))
                 for k, p in parts.items()}
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return Cell(name, w["chips"], parts["config"], parts["traffic"],
                parts["check"], e2e, layer)


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"hashbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """The harness's spans around calls into the program: host seconds
    and calls by name, and, in a traced run, a profiler range each."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.totals: Dict[str, list] = {}

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name
        self.rf = None

    def __enter__(self):
        if self.spans.traced:
            from torch.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        tot = self.spans.totals.setdefault(self.name, [0, 0])
        tot[0] += 1
        tot[1] += dt
        return False


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """Runs the cell once → {"result": the result line's object,
    "checks": [(name, value, limit)], "notes": the check's readings
    that have no limit (what it compared), "forbidden": the modules of
    ``FORBIDDEN`` loaded, "window", and set-up and check seconds}."""
    import torch
    from repro_torch.kernels import ops
    from hashbench import trace as tr
    from hashbench.roofline import peaks as peaks_mod

    loop = importlib.import_module(
        f"hashbench.loops.{cell.traffic['loop']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_import = time.perf_counter() - t_start
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    state = loop.setup(cell, seed, dev)
    setup_s = time.perf_counter() - t_start
    spans = Spans(trace)
    before = ops.counts()
    prof = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        with record_function(tr.WINDOW):
            win = loop.window(state, seconds, spans)
            torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
    else:
        win = loop.window(state, seconds, spans)
    after = ops.counts()
    mem = torch.cuda.max_memory_allocated(dev) if cuda else 0
    bad_mods = forbidden_modules()
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(mem)}
    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        profile_ = (tr.read_profile(prof, spans.totals)
                    if prof is not None else None)
        del prof
        rec = tr.Record(
            calls=win.calls, wall_s=win.wall_s,
            counters={k: after[k] - before.get(k, 0) for k in after},
            spans={k: (v[0], v[1] * 1e-9) for k, v in spans.totals.items()},
            values=win.values, shapes=loop.shapes(state),
            peaks=peaks_mod.for_device(dev), profile=profile_)
        for m in cell.per_layer:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if profile_ is not None:
            device_info["busy_s"] = profile_.busy_s
            device_info["window_s"] = profile_.window_s
            breakdown = {"device_ops": profile_.device_ops,
                         "idle_gaps": profile_.idle_gaps}
    else:
        values = dict(win.metrics, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    t_check = time.perf_counter()
    readings, failed = loop.check(state)
    check_s = time.perf_counter() - t_check
    limits = cell.check["limits"]
    checks = [(name, float(readings[name]), float(limits[name]))
              for name in limits]
    notes = {k: v for k, v in readings.items() if k not in limits}
    correct = all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": int(win.attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    bad_mods = sorted(set(bad_mods) | set(forbidden_modules()))
    return {"result": result, "checks": checks, "notes": notes,
            "forbidden": bad_mods,
            "window": win, "setup_s": setup_s, "check_s": check_s,
            "phases": dict(getattr(state, "phases", {}), import_s=t_import)}
