"""Training: the LIBLINEAR objectives, metrics and the TRON trainers of
the paper's experiment; minibatch SGD steps, the in-memory SGD baseline,
the streaming trainer over packed shards, its data-parallel step and its
restart supervisors, and the LM zoo's microbatched step (counterpart of
``repro/train``, the same exports).

The exports load on first use (a module ``__getattr__``), so that
``python -m repro_torch.train.worker`` starts a gang worker without
importing the supervisor that imports it.
"""
import importlib

_MODULES = {
    "losses": ("logistic", "hinge", "squared_hinge", "softmax_xent",
               "binary_margins", "liblinear_objective", "mean_loss_fn",
               "mean_loss_with_preds_fn", "sum_loss_with_hits_fn",
               "LOSSES"),
    "data_parallel": ("build_dp_averaged_train_step", "device_put_sharded"),
    "steps": ("TrainState", "init_state", "build_train_step",
              "build_microbatched_train_step", "AveragedTrainState", "init_averaged_state",
              "build_averaged_train_step"),
    "metrics": ("accuracy", "batched_accuracy", "trees_bitwise_equal"),
    "linear_trainer": ("FitResult", "train_bbit_liblinear",
                       "train_vw_liblinear", "train_bbit_sgd"),
    "streaming": ("StreamFitResult", "fit_streaming"),
    "supervisor": ("CrashRecord", "RestartPolicy", "SupervisedRun",
                   "run_supervised", "MultiProcessRun",
                   "run_multiprocess_supervised"),
}
_HOME = {name: module for module, names in _MODULES.items()
         for name in names}
__all__ = list(_HOME)


def __getattr__(name: str):
    module = _HOME.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
