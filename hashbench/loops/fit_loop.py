"""Closed loop of TRON fits (``train_bbit_liblinear``), one at a time.

Every call is a whole fit and its accuracy pass, from the trainer's own
start, on int32 codes held on the card.  The training sets are the
configuration's instances (``tron_instance_seeds``) of its codes' law,
fitted in turn: the window runs whole cycles over them, so ``fit_s`` is
the mean over the same instances in every run, whatever iterations each
takes.  B8's plan of each training set is built at set-up and served
from the program's cache after that, as for a user who sweeps C over a
few sets of codes.  The check holds every fit of the window to the
float64 reference on its own codes: the gradient at the fitted table
(relative to the gradient at the start, in the 2-norm and the largest
entry), the objective the fit reports, and both accuracies.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from hashbench.loops import Window
from hashbench.gen import sub_seed
from hashbench.gen.codes import class_codes
from hashbench.reference import linear as ref

CHECKS = ("grad_rel", "grad_inf", "obj_gap", "acc_gap")


@dataclasses.dataclass
class Data:
    """One instance: its training and test codes and labels."""
    x_tr: torch.Tensor
    y_tr: torch.Tensor
    x_te: torch.Tensor
    y_te: torch.Tensor


@dataclasses.dataclass
class State:
    cell: object
    device: torch.device
    data: List[Data]
    lin: object
    fits: list = dataclasses.field(default_factory=list)   # (instance, fit)
    phases: dict = dataclasses.field(default_factory=dict)


def linear_config(cfg: dict):
    from repro_torch.models.linear import BBitLinearConfig
    return BBitLinearConfig(k=cfg["k"], b=cfg["b"],
                            n_classes=cfg["n_classes"],
                            param_dtype=cfg["param_dtype"])


def run_fit(state: State, i: int, max_iter: Optional[int] = None):
    """``train_bbit_liblinear`` on instance ``i``, at the configuration's
    ``tron_max_iter`` unless ``max_iter`` is given."""
    from repro_torch.train import linear_trainer
    cfg, d = state.cell.config, state.data[i]
    return linear_trainer.train_bbit_liblinear(
        d.x_tr, d.y_tr, d.x_te, d.y_te, state.lin,
        loss=cfg["loss"], C=cfg["C"],
        max_iter=cfg["tron_max_iter"] if max_iter is None else max_iter,
        device=state.device)


def make_inputs(cfg: dict, seed: int, device: torch.device,
                instance: int) -> Data:
    """The codes of one instance of the configuration's law.  The
    training documents and the prototypes are the instance's own, the
    same in every run: TRON's path follows the rounding of its own sums,
    so any other training set, even one reordered or relabelled, can
    take other iterations and another time.  The test
    documents, drawn from the same prototypes, come from the run's
    seed."""
    n = cfg["train_docs"]
    law = (cfg["k"], cfg["b"], cfg["resemblance_low"],
           cfg["resemblance_high"], cfg["label_flip"], instance)
    x_tr, y_tr = class_codes(n, *law, instance, device)
    x_te, y_te = class_codes(cfg["n_docs"] - n, *law,
                             sub_seed(seed, f"test_docs.{instance}"), device)
    return Data(x_tr, y_tr, x_te, y_te)


def setup(cell, seed: int, device: torch.device) -> State:
    cfg = cell.config
    t0 = time.perf_counter()
    state = State(cell, device,
                  [make_inputs(cfg, seed, device, inst)
                   for inst in cfg["tron_instance_seeds"]],
                  linear_config(cfg))
    t1 = time.perf_counter()
    run_fit(state, 0)                # warm-up: every shape, B8's plan
    for i in range(1, len(state.data)):
        run_fit(state, i, max_iter=1)    # the other instances' plans
    state.phases = {"inputs_s": t1 - t0,
                    "warmup_s": time.perf_counter() - t1}
    return state


def window(state: State, seconds: float, span) -> Window:
    """Whole cycles over the instances until ``seconds`` have passed."""
    state.fits = []
    ends = []
    t0 = time.perf_counter()
    while not ends or ends[-1] < seconds:
        for i in range(len(state.data)):
            with span("train_bbit_liblinear"):
                state.fits.append((i, run_fit(state, i)))
            ends.append(time.perf_counter() - t0)
    n, wall = len(state.fits), ends[-1]
    fits = [f for _, f in state.fits]
    return Window({"fit_s": wall / n}, n, n, wall,
                  {"fit_seconds": [b - a for a, b in zip([0.0] + ends, ends)],
                   "instance": [i for i, _ in state.fits],
                   "n_iter": [f.n_iter for f in fits],
                   "train_acc": [f.train_acc for f in fits],
                   "test_acc": [f.test_acc for f in fits]})


def shapes(state: State) -> dict:
    cfg = state.cell.config
    k, v = cfg["k"], 1 << cfg["b"]

    def distinct(codes):
        seen = torch.zeros(k * v, dtype=torch.bool, device=codes.device)
        off = v * torch.arange(k, device=codes.device, dtype=torch.int64)
        for lo in range(0, codes.shape[0], 1 << 16):
            seen[(codes[lo:lo + (1 << 16)].to(torch.int64) + off)
                 .reshape(-1)] = True
        return int(seen.sum())

    # the window fits every instance equally often (whole cycles)
    mean = lambda xs: sum(xs) / len(xs)
    return {"k": k, "vsize": v, "n_out": 1,
            "train_rows": int(state.data[0].x_tr.shape[0]),
            "test_rows": int(state.data[0].x_te.shape[0]),
            "train_distinct": mean([distinct(d.x_tr) for d in state.data]),
            "test_distinct": mean([distinct(d.x_te) for d in state.data])}


def judge(state: State, fits: List[Tuple[int, tuple]]
          ) -> List[Dict[str, float]]:
    """The readings of each of ``fits``, each (instance, (table, bias,
    objective, train_acc, test_acc) as the fit reported them), against
    the float64 reference on that instance's codes; a fit equal to the
    instance's one before it bit for bit reads the same."""
    C = state.cell.config["C"]
    start, last, out = {}, {}, []
    for i, fit in fits:
        d = state.data[i]
        table, bias, obj, tr_acc, te_acc = fit
        if i not in start:
            zero_t = torch.zeros_like(table, dtype=torch.float64)
            zero_b = torch.zeros(1, dtype=torch.float64, device=table.device)
            g0t, g0b = ref.gradient(zero_t, zero_b, d.x_tr, d.y_tr, C)
            start[i] = (math.sqrt(float((g0t ** 2).sum() + g0b ** 2)),
                        max(float(g0t.abs().max()), float(g0b.abs())))
        prev = last.get(i)
        if not (prev is not None and torch.equal(table, prev[0][0])
                and torch.equal(bias, prev[0][1]) and fit[2:] == prev[0][2:]):
            g0_norm, g0_max = start[i]
            gt, gb = ref.gradient(table, bias, d.x_tr, d.y_tr, C)
            f64 = ref.objective(table, bias, d.x_tr, d.y_tr, C)
            read = {
                "grad_rel": math.sqrt(float((gt ** 2).sum() + gb ** 2))
                / g0_norm,
                "grad_inf": max(float(gt.abs().max()), float(gb.abs()))
                / g0_max,
                "obj_gap": abs(obj - f64) / abs(f64),
                "acc_gap": max(
                    abs(tr_acc - ref.accuracy(table, bias, d.x_tr, d.y_tr)),
                    abs(te_acc - ref.accuracy(table, bias, d.x_te, d.y_te)))}
            last[i] = (fit, read)
        out.append(last[i][1])
    return out


def as_checked(fit) -> tuple:
    """A ``FitResult`` as ``judge`` takes it."""
    p = fit.params
    return (p["table"], p["bias"], float(fit.objective),
            float(fit.train_acc), float(fit.test_acc))


def check(state: State) -> Tuple[Dict[str, float], int]:
    """(the worst reading of each number over the window's fits, the
    fits that passed a limit)."""
    limits = state.cell.check["limits"]
    reads = judge(state, [(i, as_checked(f)) for i, f in state.fits])
    worst = {n: max(r[n] for r in reads) for n in CHECKS}
    worst["fits_compared"] = len(reads)
    return worst, sum(any(r[n] > limits[n] for n in CHECKS) for r in reads)
