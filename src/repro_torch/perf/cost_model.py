"""Measured cost-model dispatch (counterpart of ``repro/perf/cost_model.py``;
``docs/DESIGN.md`` §2).

Every choice between a kernel and its plain torch version, and the serving
engine's micro-batch row buckets, goes through one entry point,
:func:`choose`.  The selection order is the reference's:

    explicit ``impl=`` argument
  > :func:`forced` context (calibration, tests)
  > ``REPRO_DISPATCH`` env var (``"op=impl,op=impl"``)
  > a loaded :class:`CostTable` profile (argmin of measured seconds)
  > the static rule (the kernel where it is eligible)

with *eligibility* applied before any of them.  Each op has two arms,
``kernel`` (the CUDA kernel of ``kernels/``) and ``plain`` (its plain
torch version).  Eligibility is the port's own, the limits of its
kernels' layouts, and the device of the call's tensors:

  * on a CUDA tensor the kernel arm is eligible within its kernel's
    limits, and the plain arm only where the kernel is not;
  * on a CPU tensor only the plain arm is eligible.

So no profile, env var or forced pin ever puts a plain version on the
card's main path: a pin to an ineligible arm is ignored (and counted in
``ineligible_overrides``), as in the reference.  With no profile and no
override every choice is the static rule of ``kernels/ops.py``.  The
reference's ``pallas_mode`` op (interpret vs compiled Pallas) has no
counterpart.

Profiles are versioned JSON keyed by :func:`device_fingerprint`: the
CUDA device name, the device count and the torch version, or ``"cpu"``
on a box without CUDA.  A profile of another box, or one written by the
JAX package (its fingerprint names jax, not torch), raises
:class:`ProfileError`; :func:`maybe_load_profile` turns that into a
warning and the static rules.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import torch

# B7/B8's limit on V: B8's sum takes at most 65,535 blocks of 2,048 values
# (kernels/bbit_linear.py MAX_GRID_Y, DW_SUM_MAX_SPAN).  Not the
# reference's 4,096 (a TPU one-hot ceiling): the paper's b=16 (V=65,536)
# runs on the kernels
BBIT_KERNEL_MAX_V = 65535 * 2048
# b of packed codes that B2, B5 and B6 read or write byte by byte; B1
# packs at any b in [1, 16]
PACK_BITS = (1, 2, 4, 8)
MINHASH_PACK_BITS = tuple(range(1, 17))

KERNEL = "kernel"
PLAIN = "plain"

SCHEMA_VERSION = 1
ENV_DISPATCH = "REPRO_DISPATCH"
ENV_PROFILE = "REPRO_PROFILE"

DeviceLike = Union[str, torch.device]


class ProfileError(ValueError):
    """Raised for corrupt, wrong-schema, or wrong-device profiles."""


# ---------------------------------------------------------------------------
# fingerprint + shape buckets


def device_fingerprint() -> Dict[str, object]:
    """This box: the CUDA device's name and count and the torch version,
    or the CPU."""
    if torch.cuda.is_available():
        return {"backend": "cuda",
                "device_kind": torch.cuda.get_device_name(0),
                "device_count": torch.cuda.device_count(),
                "torch": torch.__version__}
    return {"backend": "cpu", "device_kind": "cpu", "device_count": 1,
            "torch": torch.__version__}


def fingerprint_key(fp: Mapping[str, object]) -> str:
    """The part of the fingerprint a profile must match to be usable:
    ``"cpu"``, or ``"cuda|<name>|<count>|torch <version>"``.  A profile
    of the JAX package carries no torch version and keys as
    ``"jax|<backend>|<kind>|<count>"``, which no box of the port
    matches."""
    if "torch" not in fp:
        return (f"jax|{fp.get('backend')}|{fp.get('device_kind')}"
                f"|{fp.get('device_count')}")
    if fp.get("backend") == "cpu":
        return "cpu"
    return (f"{fp.get('backend')}|{fp.get('device_kind')}"
            f"|{fp.get('device_count')}|torch {fp.get('torch')}")


def _pow2_at_least(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


# shape keys bucketed to the next power of two (data-dependent sizes);
# everything else (k, b, v, scheme, ...) is part of the bucket verbatim
_BUCKETED_KEYS = frozenset({"rows", "nnz", "width", "m"})


def shape_bucket(shape: Optional[Mapping[str, object]]) -> str:
    if not shape:
        return "-"
    parts = []
    for key in sorted(shape):
        val = shape[key]
        if key in _BUCKETED_KEYS:
            val = _pow2_at_least(int(val))
        parts.append(f"{key}={val}")
    return ",".join(parts)


# ---------------------------------------------------------------------------
# op registry


def _on_card(device: DeviceLike) -> bool:
    """True for a CUDA device; False for the CPU; any other device
    raises, as the kernel wrappers do."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain version for device "
                         f"{device}")
    return kind == "cuda"


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _encode_ok(shape) -> bool:
    # B3 and B4 take any b and any k their scheme accepts (an OPH k that
    # is not a power of two raises in both versions)
    return True


def _encode_packed_ok(shape) -> bool:
    b = int(shape.get("b", 0))
    if str(shape.get("scheme", "minwise")).startswith("oph"):
        return b in PACK_BITS                 # B2
    return b in MINHASH_PACK_BITS             # B1


def _logits_ok(shape) -> bool:
    return int(shape.get("v", 1)) <= BBIT_KERNEL_MAX_V      # B7, B8


def _logits_packed_ok(shape) -> bool:
    return int(shape.get("b", 0)) in PACK_BITS              # B5, B6


def _hamming_ok(shape) -> bool:
    return True                                             # B10, any b


def _kernel_or_plain(kernel_ok: Callable[[Mapping[str, object]], bool]):
    def eligible(shape, device: DeviceLike = "cpu") -> Tuple[str, ...]:
        if _on_card(device) and kernel_ok(shape):
            return (KERNEL,)
        return (PLAIN,)
    return eligible


def _first_eligible(shape, eligible) -> str:
    return eligible[0]


@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    impls: Tuple[str, ...]
    eligible: Callable[..., Tuple[str, ...]]
    heuristic: Callable[[Mapping[str, object], Tuple[str, ...]], str]
    calibrated: bool = True


OPS: Dict[str, OpSpec] = {}


def _register(spec: OpSpec) -> None:
    OPS[spec.name] = spec


# scheme-level encode: codes out (B3 minwise, B4 OPH)
_register(OpSpec("encode", (KERNEL, PLAIN), _kernel_or_plain(_encode_ok),
                 _first_eligible))
# scheme-level fused encode → pack: packed bytes out (B1, B2)
_register(OpSpec("encode_packed", (KERNEL, PLAIN),
                 _kernel_or_plain(_encode_packed_ok), _first_eligible))
# logits over widened int codes (B7)
_register(OpSpec("logits", (KERNEL, PLAIN), _kernel_or_plain(_logits_ok),
                 _first_eligible))
# logits straight off packed bytes (B5)
_register(OpSpec("logits_packed", (KERNEL, PLAIN),
                 _kernel_or_plain(_logits_packed_ok), _first_eligible))
# the dW of each (B8, B6): never flipped by a profile, as in the reference
_register(OpSpec("logits_bwd", (KERNEL, PLAIN),
                 _kernel_or_plain(_logits_ok), _first_eligible,
                 calibrated=False))
_register(OpSpec("logits_packed_bwd", (KERNEL, PLAIN),
                 _kernel_or_plain(_logits_packed_ok), _first_eligible,
                 calibrated=False))
# retrieval candidate distances (B10)
_register(OpSpec("hamming_topk", (KERNEL, PLAIN),
                 _kernel_or_plain(_hamming_ok), _first_eligible))
# serving's fused encode → score: one arm, calibrated for its cost per
# dispatch (micro-batch sizing), never a choice
_register(OpSpec("serve_score", ("fused",), lambda s, device="cpu": ("fused",),
                 lambda s, e: "fused"))


# ---------------------------------------------------------------------------
# CostTable


@dataclasses.dataclass
class CostTable:
    """Measured seconds per (op, impl, shape-bucket), device-keyed."""

    fingerprint: Dict[str, object]
    entries: Dict[str, float] = dataclasses.field(default_factory=dict)
    table_version: str = "uncalibrated"
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @staticmethod
    def key(op: str, impl: str, bucket: str) -> str:
        return f"{op}|{impl}|{bucket}"

    def put(self, op: str, impl: str,
            shape: Optional[Mapping[str, object]], seconds: float) -> None:
        self.entries[self.key(op, impl, shape_bucket(shape))] = float(seconds)

    def lookup(self, op: str, impl: str,
               shape: Optional[Mapping[str, object]] = None,
               *, bucket: Optional[str] = None) -> Optional[float]:
        if bucket is None:
            bucket = shape_bucket(shape)
        return self.entries.get(self.key(op, impl, bucket))

    def matches_device(self) -> bool:
        return (fingerprint_key(self.fingerprint)
                == fingerprint_key(device_fingerprint()))

    def to_json(self) -> Dict[str, object]:
        return {
            "schema": SCHEMA_VERSION,
            "table_version": self.table_version,
            "fingerprint": self.fingerprint,
            "meta": self.meta,
            "entries": self.entries,
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "CostTable":
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError) as e:
            raise ProfileError(f"unreadable profile {path!r}: {e}") from e
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
            raise ProfileError(
                f"profile {path!r}: unsupported schema "
                f"{raw.get('schema') if isinstance(raw, dict) else type(raw)}")
        fp = raw.get("fingerprint")
        entries = raw.get("entries")
        if not isinstance(fp, dict) or not isinstance(entries, dict):
            raise ProfileError(f"profile {path!r}: malformed body")
        try:
            entries = {str(k): float(v) for k, v in entries.items()}
        except (TypeError, ValueError) as e:
            raise ProfileError(f"profile {path!r}: non-numeric entry: "
                               f"{e}") from e
        return cls(fingerprint=fp, entries=entries,
                   table_version=str(raw.get("table_version", "?")),
                   meta=dict(raw.get("meta") or {}))


# ---------------------------------------------------------------------------
# the model: choose + observability


def _parse_env_dispatch(raw: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        op, _, impl = part.partition("=")
        if op.strip() and impl.strip():
            out[op.strip()] = impl.strip()
    return out


class CostModel:
    """Process-wide dispatch state: loaded profile, forced pins,
    per-(op, bucket) decision log, hit/fallback counters."""

    def __init__(self, table: Optional[CostTable] = None):
        self.table = table
        self._lock = threading.Lock()
        self._forced: Dict[str, str] = {}
        self.counts = {"explicit": 0, "forced": 0, "env": 0,
                       "profile": 0, "heuristic": 0, "ineligible": 0}
        self.choices: Dict[str, str] = {}   # "op|bucket" -> impl

    # -- profile management -------------------------------------------------

    def set_table(self, table: Optional[CostTable],
                  *, strict: bool = True) -> None:
        if table is not None and not table.matches_device():
            if strict:
                raise ProfileError(
                    "profile fingerprint "
                    f"{fingerprint_key(table.fingerprint)!r} does not match "
                    f"this device {fingerprint_key(device_fingerprint())!r}")
            table = None
        with self._lock:
            self.table = table

    # -- selection ----------------------------------------------------------

    def choose(self, op: str,
               shape: Optional[Mapping[str, object]] = None,
               *, device: DeviceLike = "cpu",
               impl: Optional[str] = None) -> str:
        spec = OPS[op]
        shape = dict(shape or {})
        eligible = spec.eligible(shape, device)
        bucket = shape_bucket(shape)

        source = None
        picked: Optional[str] = None
        if impl is not None:
            if impl in eligible:
                source, picked = "explicit", impl
            else:
                with self._lock:
                    self.counts["ineligible"] += 1
        if picked is None:
            forced = self._forced.get(op)
            if forced is not None and forced in eligible:
                source, picked = "forced", forced
        if picked is None:
            env = os.environ.get(ENV_DISPATCH)
            if env:
                want = _parse_env_dispatch(env).get(op)
                if want is not None and want in eligible:
                    source, picked = "env", want
        # a profile decides a bucket where it measured every eligible arm;
        # with one arm eligible (the port's rule) that is the measured arm
        if picked is None and spec.calibrated:
            table = self.table
            if table is not None:
                costs = {i: table.lookup(op, i, bucket=bucket)
                         for i in eligible}
                if all(c is not None for c in costs.values()):
                    source, picked = "profile", min(costs, key=costs.get)
        if picked is None:
            picked = spec.heuristic(shape, eligible)
            source = "heuristic"

        with self._lock:
            self.counts[source] = self.counts.get(source, 0) + 1
            self.choices[f"{op}|{bucket}"] = picked
        return picked

    # -- forcing (calibration + tests) --------------------------------------

    def force(self, pins: Mapping[str, str]) -> "_ForcedCtx":
        return _ForcedCtx(self, dict(pins))

    # -- observability ------------------------------------------------------

    def report(self) -> Dict[str, object]:
        with self._lock:
            table = self.table
            return {
                "table_version": (table.table_version if table is not None
                                  else None),
                "profile_loaded": table is not None,
                "fingerprint": fingerprint_key(device_fingerprint()),
                "hits": self.counts["profile"],
                "fallbacks": self.counts["heuristic"],
                "overrides": (self.counts["explicit"]
                              + self.counts["forced"] + self.counts["env"]),
                "ineligible_overrides": self.counts["ineligible"],
                "choices": dict(self.choices),
            }


class _ForcedCtx:
    def __init__(self, model: CostModel, pins: Dict[str, str]):
        self._model, self._pins, self._saved = model, pins, {}

    def __enter__(self):
        with self._model._lock:
            for op, impl in self._pins.items():
                if op not in OPS:
                    raise KeyError(f"unknown dispatch op {op!r}")
                self._saved[op] = self._model._forced.get(op)
                self._model._forced[op] = impl
        return self._model

    def __exit__(self, *exc):
        with self._model._lock:
            for op, prev in self._saved.items():
                if prev is None:
                    self._model._forced.pop(op, None)
                else:
                    self._model._forced[op] = prev
        return False


# ---------------------------------------------------------------------------
# module-level singleton

_MODEL_LOCK = threading.Lock()
_MODEL: Optional[CostModel] = None


def get_model() -> CostModel:
    global _MODEL
    if _MODEL is None:
        with _MODEL_LOCK:
            if _MODEL is None:
                model = CostModel()
                path = os.environ.get(ENV_PROFILE)
                if path:
                    try:
                        model.set_table(CostTable.load(path), strict=True)
                    except ProfileError as e:
                        warnings.warn(f"ignoring {ENV_PROFILE}: {e}")
                _MODEL = model
    return _MODEL


def reset() -> None:
    """Drop all dispatch state (tests)."""
    global _MODEL
    with _MODEL_LOCK:
        _MODEL = None


def choose(op: str, shape: Optional[Mapping[str, object]] = None,
           *, device: DeviceLike = "cpu", impl: Optional[str] = None) -> str:
    """The arm of ``op`` for a call at ``shape`` on tensors of ``device``
    (``"kernel"`` or ``"plain"``; ``"fused"`` for ``serve_score``)."""
    return get_model().choose(op, shape, device=device, impl=impl)


def refuse_plain_on_card(op: str, shape: Optional[Mapping[str, object]],
                         device: DeviceLike, who: str) -> None:
    """Raises ``ValueError`` where a caller asks explicitly for the plain
    arm of ``op`` on a CUDA device whose kernel is eligible: the port runs
    no plain version on the card's main path, so such a request is a
    mistake, not a choice."""
    if _on_card(device) and PLAIN not in OPS[op].eligible(dict(shape or {}),
                                                          device):
        raise ValueError(
            f"{who} asks for the plain torch version of {op!r} on {device}, "
            f"where its kernel runs: the port never runs a plain version on "
            f"the card when a kernel applies.  Pass CPU tensors "
            f"(device='cpu') for the plain versions, or leave the choice "
            f"to the cost model (use_kernel='auto')")


def forced(**pins: str) -> _ForcedCtx:
    """Context manager pinning ops to impls, e.g.
    ``with perf.forced(logits="kernel"): ...``: the in-process analog of
    ``REPRO_DISPATCH`` (and what calibration uses to time each arm).  A
    pin to an arm that is not eligible for a call is ignored."""
    return get_model().force(pins)


def dispatch_report() -> Dict[str, object]:
    return get_model().report()


def set_profile(table_or_path, *, strict: bool = True) -> Optional[CostTable]:
    """Install a profile (``CostTable`` or path).  ``strict`` raises on
    device-fingerprint mismatch; otherwise the profile is dropped and
    dispatch stays on the static rules.  Returns the installed table."""
    model = get_model()
    table = (CostTable.load(table_or_path)
             if isinstance(table_or_path, str) else table_or_path)
    model.set_table(table, strict=strict)
    return model.table


def clear_profile() -> None:
    get_model().set_table(None)


def maybe_load_profile(path: Optional[str]) -> bool:
    """Best-effort profile install for launchers: missing file, corrupt
    JSON, or wrong device ⇒ False and the static rules."""
    if not path or not os.path.exists(path):
        return False
    try:
        set_profile(path, strict=True)
    except ProfileError as e:
        warnings.warn(f"ignoring profile {path!r}: {e}")
        return False
    return True


# ---------------------------------------------------------------------------
# micro-batch sizing off the serve_score cost curve

# keep a smaller row bucket only when dispatching at it beats padding
# up to the next kept bucket by at least this margin — otherwise the
# bucket just costs an extra warmed shape
_ROW_BUCKET_MARGIN = 0.85

# a smaller drain cap must beat the bigger batch's cost-per-row by >10%
# to win: ties and measurement noise resolve to the LARGEST batch
# (bigger batches amortize per-dispatch overhead the curve can't see)
_LANE_CAP_TOLERANCE = 1.10


def _serve_curve(table: CostTable, base_shape: Dict[str, object],
                 candidates: Iterable[int]) -> Optional[Dict[int, float]]:
    curve = {}
    for rows in candidates:
        cost = table.lookup("serve_score", "fused",
                            dict(base_shape, rows=rows))
        if cost is None or cost <= 0:
            return None
        curve[rows] = cost
    return curve


def _pow2_candidates(max_batch: int) -> Tuple[int, ...]:
    out, r = [], 1
    top = _pow2_at_least(max_batch)
    while r <= top:
        out.append(r)
        r *= 2
    return tuple(out)


def suggest_row_buckets(
        k: int, b: int, scheme: str, max_batch: int,
        nnz_buckets: Iterable[int],
        table: Optional[CostTable] = None,
) -> Optional[Dict[int, Tuple[int, ...]]]:
    """Per-nnz-lane row buckets from the measured ``serve_score``
    cost-per-dispatch curve.  Buckets whose cost is within
    ``1 - _ROW_BUCKET_MARGIN`` of just padding up to the next size are
    pruned (fewer warmed shapes, bigger effective batches).  Returns
    None — caller keeps the static pow-2 grid — whenever the profile
    lacks full coverage."""
    table = table if table is not None else get_model().table
    if table is None or not table.matches_device():
        return None
    candidates = _pow2_candidates(max_batch)
    out: Dict[int, Tuple[int, ...]] = {}
    for m in nnz_buckets:
        base = {"k": k, "b": b, "scheme": scheme, "nnz": m}
        curve = _serve_curve(table, base, candidates)
        if curve is None:
            return None
        keep = [candidates[-1]]
        for rows in reversed(candidates[:-1]):
            if curve[rows] <= _ROW_BUCKET_MARGIN * curve[keep[0]]:
                keep.insert(0, rows)
        out[int(m)] = tuple(keep)
    return out


def suggest_lane_caps(
        k: int, b: int, scheme: str, max_batch: int,
        nnz_buckets: Iterable[int],
        table: Optional[CostTable] = None,
) -> Optional[Dict[int, int]]:
    """Throughput-optimal micro-batch per nnz lane: the LARGEST row
    bucket whose measured cost *per row* is within
    ``_LANE_CAP_TOLERANCE`` of the curve's best — noise and flat curves
    resolve to max batch.  None without full coverage."""
    table = table if table is not None else get_model().table
    if table is None or not table.matches_device():
        return None
    candidates = _pow2_candidates(max_batch)
    out: Dict[int, int] = {}
    for m in nnz_buckets:
        base = {"k": k, "b": b, "scheme": scheme, "nnz": m}
        curve = _serve_curve(table, base, candidates)
        if curve is None:
            return None
        best = min(curve[r] / r for r in candidates)
        out[int(m)] = max(r for r in candidates
                          if curve[r] / r <= best * _LANE_CAP_TOLERANCE)
    return out
