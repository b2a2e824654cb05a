"""Roofline terms of the dry-run's traced steps (counterpart of
``repro/launch/roofline.py``).

Hardware model, one NVIDIA H100 SXM (80 GB HBM3) a rank:

  * ``peak_flops`` 989.4e12 — dense bfloat16 Tensor Core FLOP/s without
    sparsity (NVIDIA H100 Tensor Core GPU datasheet, SXM5 column,
    1,979 TFLOPS "with sparsity" halved);
  * ``hbm_bw`` 3.35e12 B/s — HBM3 bandwidth (same datasheet, SXM5);
  * ``wire_bw`` 50e9 B/s, one link a GPU — one 400 Gb/s NDR InfiniBand
    port a GPU (ConnectX-7, the DGX H100 / HGX reference design).  Every
    data and model group of the 16 × 16 mesh spans more than one 8-GPU
    node, so its collectives cross that port; NVLink's 450 GB/s a
    direction inside a node does not bound them.

Accounting (``trace_step``): one call of a step runs on this rank's
local shards on the meta device (nothing is allocated or computed) with
a dispatch mode that sees each local op:

  * FLOPs from ``torch.utils.flop_counter``'s formulas on the local
    shapes (a counter around the DTensor ops would count the global
    product, not one device's);
  * bytes as each op's operands read and results written, in eager
    order.  This is unfused traffic, an upper bound on what a fused
    program moves, not XLA's post-fusion ``bytes accessed``;
  * collectives as the ``_c10d_functional`` ops the call dispatched
    (``distributed/collectives.py::collective_stats_from_trace``), ring
    multipliers applied per op (``wire_bytes``);
  * memory: the bytes of live storages the call allocated, at their
    peak (``temp``), beside the arguments' local bytes.

Without autograd, a local call (``shardings.local_apply``) identical to
an earlier one of the same trace (the next layer's attention or scan) is
counted by replay rather than run again (``_LocalOpMode.run_local``,
installed with ``shardings.local_calls_through``): identical means the
same code, argument shapes and closure values, each keyed by all of its
state, and a call whose closure holds anything else (a tensor, a dict,
an object) is always run.  internlm2-1.8b's prefill_32k traces in 20.8 s
with the replay and 432.9 s without it on a CPU, to the same counts
(PERF.md §6).

The reference assembles full-step costs from small probe compiles
because XLA counts a while-loop body once; the port's traced call runs
every loop iteration, and ``launch/probes.py`` keeps the reference's
probe arithmetic for the per-layer view.  sLSTM time-scan FLOPs are
added analytically, as in the reference.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

HW = dict(peak_flops=989.4e12, hbm_bw=3.35e12, wire_bw=50e9, wire_links=1)

__all__ = ["HW", "wire_bytes", "Cost", "optimizer_cost",
           "slstm_extra_flops", "roofline_terms", "model_flops",
           "trace_step", "StepTrace", "cost_of_trace"]


# ---------------------------------------------------------------------------
# per-trace cost extraction
# ---------------------------------------------------------------------------
def wire_bytes(stats: List[dict]) -> float:
    """Per-participant ring-model wire bytes from collective stats."""
    total = 0.0
    for st in stats:
        r = float(st["bytes"])
        s = max(int(st.get("group_size") or 0), 1)
        op = st["op"]
        if op == "all-gather":
            total += r * (s - 1) / s
        elif op == "reduce-scatter":
            total += r * (s - 1)          # input = result × S
        elif op == "all-reduce":
            total += 2 * r * (s - 1) / s
        elif op == "all-to-all":
            total += r * (s - 1) / s
        else:                             # collective-permute
            total += r
    return total


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_count: int = 0

    def __add__(self, o):
        return Cost(self.flops + o.flops, self.bytes + o.bytes,
                    self.coll_bytes + o.coll_bytes,
                    self.coll_count + o.coll_count)

    def __sub__(self, o):
        return Cost(self.flops - o.flops, self.bytes - o.bytes,
                    self.coll_bytes - o.coll_bytes,
                    self.coll_count - o.coll_count)

    def __mul__(self, k):
        return Cost(self.flops * k, self.bytes * k, self.coll_bytes * k,
                    int(self.coll_count * k))

    __rmul__ = __mul__

    def clamped(self):
        return Cost(max(self.flops, 0.0), max(self.bytes, 0.0),
                    max(self.coll_bytes, 0.0), max(self.coll_count, 0))

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StepTrace:
    """What one traced call did on this rank."""
    cost: Cost
    collectives: List[dict]
    temp_bytes: int          # peak of the storages the call allocated
    output_bytes: int        # the call's results (new storages)
    n_ops: int               # local ops (a replayed call's included)
    n_dtensor_ops: int = 0   # DTensor ops dispatched (the host's cost)


def _flop_registry() -> dict:
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False).flop_registry


def _tensors(x) -> list:
    from repro_torch.tree import leaves
    return [t for t in leaves(x) if isinstance(t, torch.Tensor)]


class _LocalOpMode:
    """A dispatch mode that counts the local ops of a DTensor program:
    it declines ops on DTensors (``NotImplemented``), so DTensor unwraps
    them and the local ops reach it; DTensor's own shape propagation on
    global metadata is run uncounted."""

    def __init__(self, known_storages):
        from torch.utils._python_dispatch import TorchDispatchMode
        mode = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return mode._dispatch(func, types, args, kwargs or {})

        self.mode = Mode()
        self.registry = _flop_registry()
        self.flops = 0.0
        self.bytes = 0.0
        self.calls: List[dict] = []     # collective_stats_from_trace's
        self.skip = 0
        self.n_ops = 0
        self.n_dtensor_ops = 0
        self.live = 0
        self.peak = 0
        self.seen = set(id(s) for s in known_storages)
        self.memo = {}

    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self.n_dtensor_ops += 1
            return NotImplemented
        out = func(*args, **kwargs)
        if self.skip or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # a replayed call's fresh results, or DTensor's shape
            # propagation on global metadata (it runs under a
            # FakeTensorMode): not a local op
            return out
        ns = func.namespace
        if ns == "prim":
            return out
        name = func._overloadpacket.__name__
        self.n_ops += 1
        if ns == "_c10d_functional":
            # read at once: a kept (args, out) would keep their storages
            # alive to the end of the trace
            from repro_torch.distributed.collectives import \
                collective_stats_from_trace
            self.calls.extend(collective_stats_from_trace(
                [(name, args, out)]))
            return out
        outs = _tensors(out)
        if not outs:
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += float(self.registry[packet](*args, **kwargs,
                                                      out_val=out))
        if getattr(func, "is_view", False):
            return out
        ins = _tensors((args, kwargs))
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if id(st) in self.seen:
            return
        n = st.nbytes()
        self.seen.add(id(st))
        self.live += n
        self.peak = max(self.peak, self.live)
        sid = id(st)

        def free(n=n, sid=sid, owner=weakref.ref(self)):
            me = owner()
            if me is not None:
                me.live -= n
                me.seen.discard(sid)
        weakref.finalize(st, free)

    # -- replay of identical local calls on meta shards ------------------
    def run_local(self, fn, args):
        """``fn(*args)`` for ``shardings.local_apply``.  Without autograd
        and on meta shards only, a call whose code, closure values and
        argument shapes equal an earlier one's is not run again: its
        counts, collectives and memory peak are replayed and fresh meta
        results of its shapes returned (the layers of a stack repeat the
        same local attention and scans)."""
        key = self._memo_key(fn, args)
        if key is None:
            return fn(*args)
        hit = self.memo.get(key)
        if hit is None:
            before = (self.flops, self.bytes, self.n_ops, len(self.calls))
            live0, peak0 = self.live, self.peak
            self.peak = self.live
            out = fn(*args)
            inner = self.peak - live0
            self.peak = max(peak0, self.peak)
            outs = _tensors(out)
            self.memo[key] = dict(
                flops=self.flops - before[0], bytes=self.bytes - before[1],
                n_ops=self.n_ops - before[2],
                calls=list(self.calls[before[3]:]), inner=inner,
                single=isinstance(out, torch.Tensor),
                outs=[(tuple(t.shape), tuple(t.stride()), t.dtype)
                      for t in outs])
            return out
        self.flops += hit["flops"]
        self.bytes += hit["bytes"]
        self.n_ops += hit["n_ops"]
        self.calls.extend(hit["calls"])
        self.peak = max(self.peak, self.live + hit["inner"])
        self.skip += 1
        try:
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in hit["outs"]]
        finally:
            self.skip -= 1
        for t in outs:
            self._track(t)
        return outs[0] if hit["single"] else tuple(outs)

    @staticmethod
    def _memo_key(fn, args):
        if torch.is_grad_enabled() or not hasattr(fn, "__code__"):
            return None
        parts = []
        for a in args:
            if isinstance(a, torch.Tensor):
                if a.device.type != "meta":
                    return None
                parts.append((tuple(a.shape), tuple(a.stride()), a.dtype))
                continue
            k = _value_key(a, 0)
            if k is None:
                return None
            parts.append(k)
        cells = _closure_key(fn)
        if cells is None:
            return None
        return (fn.__code__, tuple(parts), cells)


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device)


def _value_key(v, depth: int):
    """A hashable key that holds all of ``v``'s state, or None where
    there is none: plain values, tuples, lists and dicts of them (by
    their contents at the call), frozen dataclasses (configs) by value;
    a mesh or process group by identity (their state does not change);
    functions by code and closure."""
    if isinstance(v, _PLAIN):
        return (type(v).__name__, v)
    if isinstance(v, (tuple, list)):
        keys = tuple(_value_key(x, depth) for x in v)
        return None if any(k is None for k in keys) else \
            (type(v).__name__, keys)
    if isinstance(v, dict):
        # keyed by its items at the call: all of its state then
        return _value_key(tuple((k, x) for k, x in sorted(v.items())),
                          depth)
    if dataclasses.is_dataclass(v) and not isinstance(v, type) and \
            v.__dataclass_params__.frozen:
        return _value_key(tuple(getattr(v, f.name)
                                for f in dataclasses.fields(v)), depth)
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(v, (DeviceMesh, torch.distributed.ProcessGroup)):
        return ("id", id(v))
    if hasattr(v, "__code__") and depth < 4:
        inner = _closure_key(v, depth + 1)
        return None if inner is None else (v.__code__, inner)
    return None


def _closure_key(fn, depth: int = 0):
    """A hashable key of ``fn``'s closure values (``_value_key``; a fresh
    lambda each call still keys the same); None where a value's state
    is not all in its key (a tensor, a dict, any other object): such a
    call is always run."""
    cells = []
    for c in fn.__closure__ or ():
        k = _value_key(c.cell_contents, depth)
        if k is None:
            return None
        cells.append(k)
    return tuple(cells)


def _storages(tree) -> list:
    from repro_torch.distributed.shardings import is_dtensor
    out = []
    for t in _tensors(tree):
        loc = t.to_local() if is_dtensor(t) else t
        out.append(loc.untyped_storage())
    return out


def trace_step(fn: Callable, *args, replay: bool = True) -> tuple:
    """Runs ``fn(*args)`` once with every local op counted → (its
    result, ``StepTrace``).  Call it on meta shards (the dry-run) to
    count without computing; on real tensors it computes as well.
    ``replay=False`` runs every local call (the same counts, slower)."""
    import contextlib

    from repro_torch.distributed import shardings
    known = _storages(args)
    counter = _LocalOpMode(known)
    local = shardings.local_calls_through(counter.run_local) if replay \
        else contextlib.nullcontext()
    with local, counter.mode:
        out = fn(*args)
    stats = counter.calls
    known_ids = set(id(s) for s in known)
    out_bytes = sum(s.nbytes() for s in _storages(out)
                    if id(s) not in known_ids)
    cost = Cost(flops=counter.flops, bytes=counter.bytes,
                coll_bytes=wire_bytes(stats), coll_count=len(stats))
    return out, StepTrace(cost=cost, collectives=stats,
                          temp_bytes=int(counter.peak),
                          output_bytes=int(out_bytes),
                          n_ops=counter.n_ops,
                          n_dtensor_ops=counter.n_dtensor_ops)


def cost_of_trace(fn: Callable, *args) -> Cost:
    """The reference's ``cost_of_compiled``: the Cost of one traced call
    of ``fn(*args)`` on this rank's shards."""
    return trace_step(fn, *args)[1].cost


# ---------------------------------------------------------------------------
# analytic pieces
# ---------------------------------------------------------------------------
def optimizer_cost(n_params: int, n_devices: int, moment_dtype: str,
                   param_bytes: int = 2) -> Cost:
    """AdamW update, per-device share (params fully sharded)."""
    n = n_params / n_devices
    m_bytes = {"float32": 4, "bfloat16": 2, "int8": 1}[moment_dtype]
    # read g + p + m + v, write p + m + v  (+scales noise for int8)
    bytes_ = n * (param_bytes * 2 + 4 + (m_bytes * 2) * 2)
    return Cost(flops=14.0 * n, bytes=bytes_, coll_bytes=0.0)


def slstm_extra_flops(cfg, batch: int, seq: int, n_devices: int) -> float:
    """Recurrent sLSTM FLOPs that hide inside a time scan (train: ×3
    for fwd+bwd+remat-recompute)."""
    if cfg.family != "ssm":
        return 0.0
    groups = cfg.n_layers // cfg.slstm_every
    p = cfg.d_model // cfg.n_heads
    rec = 2 * cfg.n_heads * p * (4 * p)      # R·h per step
    return groups * batch * seq * rec / n_devices


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------
def roofline_terms(total: Cost, chips_per_pod_dim: Optional[int] = None
                   ) -> Dict[str, Any]:
    del chips_per_pod_dim
    compute_s = total.flops / HW["peak_flops"]
    memory_s = total.bytes / HW["hbm_bw"]
    coll_s = total.coll_bytes / (HW["wire_links"] * HW["wire_bw"])
    dominant = max(
        [("compute", compute_s), ("memory", memory_s),
         ("collective", coll_s)], key=lambda kv: kv[1])[0]
    bound = max(compute_s, memory_s, coll_s)
    return dict(compute_s=compute_s, memory_s=memory_s,
                collective_s=coll_s, dominant=dominant,
                step_lower_bound_s=bound,
                roofline_fraction=(compute_s / bound) if bound > 0 else 0.0)


def model_flops(cfg, batch: int, seq: int, kind: str) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode D = batch·1 token."""
    n = cfg.n_active_params() if cfg.is_moe else cfg.n_params()
    tokens = batch * (seq if kind != "decode" else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
