"""Measured cost-model dispatch (counterpart of ``repro/perf``;
``docs/DESIGN.md`` §2).

``perf.choose(op, shape, device=...)`` is the single selection point
between each kernel and its plain torch version; ``perf.calibrate``
populates the measured :class:`CostTable` behind it and the serving
engine's micro-batch curve.
"""
from repro_torch.perf.cost_model import (
    BBIT_KERNEL_MAX_V,
    ENV_DISPATCH,
    ENV_PROFILE,
    OPS,
    CostTable,
    ProfileError,
    choose,
    clear_profile,
    device_fingerprint,
    dispatch_report,
    fingerprint_key,
    forced,
    get_model,
    maybe_load_profile,
    refuse_plain_on_card,
    reset,
    set_profile,
    shape_bucket,
    suggest_lane_caps,
    suggest_row_buckets,
)

__all__ = [
    "BBIT_KERNEL_MAX_V", "ENV_DISPATCH", "ENV_PROFILE", "OPS",
    "CostTable", "ProfileError", "choose", "clear_profile",
    "device_fingerprint", "dispatch_report", "fingerprint_key", "forced",
    "get_model", "maybe_load_profile", "refuse_plain_on_card", "reset",
    "set_profile", "shape_bucket", "suggest_lane_caps",
    "suggest_row_buckets", "calibrate", "summarize",
]


# ``calibrate``/``summarize`` live in the submodule of the same name,
# imported at first use.  The import machinery binds the *submodule* over
# the package attribute, so after the first resolution the functions are
# pinned into globals(); otherwise perf.calibrate(...) would work once.
def __getattr__(name):
    if name in ("calibrate", "summarize"):
        import importlib
        mod = importlib.import_module("repro_torch.perf.calibrate")
        globals()["calibrate"] = mod.calibrate
        globals()["summarize"] = mod.summarize
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
