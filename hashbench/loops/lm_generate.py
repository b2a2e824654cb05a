"""Closed-loop greedy generation of an LM zoo configuration, one client.

Set-up builds the program's model: the configuration file's
``program_config`` from ``repro_torch.configs.get_config``, with every
size the file gives (``PROGRAM_FIELDS``; at the rehearsal size, the
rehearsal's), its weights drawn on the card from the seed
(``models/api.py``'s ``init_params``), and one prompt batch for each
entry of the traffic's ``cycle`` ([batch, tokens] each), token ids
uniform over the vocabulary from the seed.  A call is one
``serving/engine.py::greedy_generate(max_new)`` of one prompt batch; the
calls go through the cycle in turn, and the window runs whole cycles.
The warm-up is one whole cycle.

``encode_docs_per_s`` is the documents prefilled and answered in the
window's cycles over the seconds to the return of the last call (whose
tokens are then on the host).

The check runs after the window, on the last cycle's call of each shape,
at the timed sizes: the program's logits at the prompt's last position
and at each generated token fed back (its prefill, then its decode steps
through the latent cache, teacher-forced by the call's own tokens) and
its routing choices, against the plain reference's full forward pass over
the same tokens (``reference/kimi_k2.py``, float32, TF32 off).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from hashbench.gen import generator
from hashbench.loops import Window
from hashbench.reference import kimi_k2 as ref

# the configuration file's keys (the published config.json's names) and
# the program's config fields they set
PROGRAM_FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab",
    "moe_intermediate_size": "moe_d_ff", "num_experts_per_tok": "moe_top_k",
    "n_shared_experts": "n_shared_experts",
    "q_lora_rank": "q_lora_rank", "kv_lora_rank": "kv_lora_rank",
    "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "first_k_dense_replace": "first_k_dense",
    "routed_scaling_factor": "moe_routed_scale", "rms_norm_eps": "norm_eps",
    "rope_theta": "rope_theta",
    "n_routed_experts": "experts_held", "router_experts": "moe_experts",
    "experts_first": "experts_first",
}
ROPE_FIELDS = {"factor": "rope_factor",
               "original_max_position_embeddings": "rope_original_max_pos",
               "beta_fast": "rope_beta_fast", "beta_slow": "rope_beta_slow",
               "mscale": "rope_mscale", "mscale_all_dim": "rope_mscale_all_dim"}


@dataclasses.dataclass
class State:
    cell: object
    device: torch.device
    seed: int
    cfg: object
    api: object
    params: dict
    prompts: List[np.ndarray]
    max_new: int
    outs: List[np.ndarray] = dataclasses.field(default_factory=list)
    phases: dict = dataclasses.field(default_factory=dict)


def model_config(conf: dict):
    """The program's config of the configuration file ``conf``."""
    from repro_torch.configs import get_config
    cfg = get_config(conf["program_config"])
    sizes = {field: conf[key] for key, field in PROGRAM_FIELDS.items()
             if key in conf}
    sizes.update({field: conf["rope_scaling"][key]
                  for key, field in ROPE_FIELDS.items()})
    sizes["d_head"] = conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"]
    sizes["dtype"] = conf["torch_dtype"]
    return dataclasses.replace(cfg, **sizes)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cycle(state: State, span) -> List[np.ndarray]:
    from repro_torch.serving.engine import greedy_generate
    outs = []
    for prompt in state.prompts:
        with span("greedy_generate"):
            outs.append(greedy_generate(state.api, state.params, prompt,
                                        state.max_new, device=state.device))
    return outs


def setup(cell, seed: int, device: torch.device) -> State:
    import contextlib
    from repro_torch.models.api import get_model_api
    t0 = time.perf_counter()
    cfg = model_config(cell.config)
    api = get_model_api(cfg)
    params = api.init_params(generator(seed, "weights", device), device)
    g = generator(seed, "prompts", device)
    prompts = [torch.randint(0, cfg.vocab, (b, s), generator=g,
                             device=device, dtype=torch.int32).cpu().numpy()
               for b, s in cell.traffic["cycle"]]
    _sync(device)
    t1 = time.perf_counter()
    state = State(cell, device, seed, cfg, api, params, prompts,
                  cell.traffic["max_new"])
    state.outs = run_cycle(state, lambda name: contextlib.nullcontext())
    _sync(device)
    state.phases = {"weights_s": t1 - t0,
                    "warmup_s": time.perf_counter() - t1,
                    "params": cfg.n_params()}
    return state


def window(state: State, seconds: float, span) -> Window:
    cycles, ends = 0, []
    t0 = time.perf_counter()
    while True:
        state.outs = run_cycle(state, span)
        cycles += 1
        wall = time.perf_counter() - t0
        ends.append(wall)
        if wall >= seconds:
            break
    docs = cycles * sum(b for b, _ in state.cell.traffic["cycle"])
    cycle_s = np.diff([0.0] + ends).tolist()
    return Window({"encode_docs_per_s": docs / wall},
                  cycles * len(state.prompts), docs, wall,
                  {"cycle_s": cycle_s})


def shapes(state: State) -> dict:
    return {"model": dataclasses.asdict(state.cfg),
            "cycle": [list(p.shape) for p in state.prompts],
            "max_new": state.max_new}


def program_logits(state: State, tokens: np.ndarray
                   ) -> Tuple[torch.Tensor, List[torch.Tensor], np.ndarray]:
    """The program fed ``tokens`` (B, S0 + max_new) as ``greedy_generate``
    feeds them: float32 logits (B, max_new, V) at positions S0 − 1 …
    S0 + max_new − 2, each MoE layer's expert ids at the prompt's tokens
    (B, S0, k; its prefill's, recorded as ``moe.route`` returns them: a
    decode step on the card replays a CUDA graph, which calls no Python),
    and the tokens its own argmax picks."""
    from repro_torch.models import moe
    from repro_torch.serving.engine import grow_cache
    api, params, dev = state.api, state.params, state.device
    b, total = tokens.shape
    s0 = total - state.max_new
    seen: List[torch.Tensor] = []
    real = moe.route

    def recording(*args, **kw):
        w, idx = real(*args, **kw)
        seen.append(idx)
        return w, idx

    moe.route = recording
    try:
        with torch.no_grad():               # as greedy_generate runs
            tok = torch.as_tensor(tokens, device=dev)
            logits, cache = api.prefill(params, {"tokens": tok[:, :s0]})
            cache = grow_cache(api.init_cache(b, total, device=dev), cache)
            out = [logits.float()]
            for t in range(s0, total - 1):
                logits, cache = api.decode_step(
                    params, {"token": tok[:, t:t + 1]}, cache, t)
                out.append(logits.float())
    finally:
        moe.route = real
    del cache
    n_moe = state.cfg.n_layers - state.cfg.first_k_dense
    routes = [r.view(b, s0, -1) for r in seen[:n_moe]]
    logits = torch.stack(out, dim=1)
    return logits, routes, logits.argmax(-1).cpu().numpy()


def reference(state: State, tokens: np.ndarray, fp8: bool = False):
    """The reference's full forward pass over ``tokens`` (B, S0 + max_new)
    but the last: float32 logits (B, max_new, V) at the positions
    ``program_logits`` reads, and each MoE layer's expert ids.  ``fp8``:
    one precision below bfloat16 (the control)."""
    total = tokens.shape[1]
    s0 = total - state.max_new
    return ref.forward(state.params, torch.as_tensor(tokens[:, :-1]),
                       ref.hp_of(state.cfg), range(s0 - 1, total - 1),
                       fp8=fp8, device=state.device)


def readings(got, want) -> Dict[str, object]:
    """(logits, routes) of a run against the reference's: each logit
    position's relative L2 error, and the (token, layer) choices at the
    prompt's tokens whose expert sets differ."""
    logits, routes = got
    want_logits, want_routes = want
    err = ((logits.to(want_logits.device) - want_logits).norm(dim=-1)
           / want_logits.norm(dim=-1)).flatten()
    n = routes[0].shape[1]
    differ = sum(int((torch.sort(p[:, :n].to(r.device), -1).values
                      != torch.sort(r[:, :n], -1).values).any(-1).sum())
                 for p, r in zip(routes, want_routes))
    return {"errors": err.cpu().tolist(), "route_differ": differ,
            "route_choices": sum(r.shape[0] * n for r in want_routes)}


def compare(state: State, tokens: np.ndarray) -> Dict[str, object]:
    """Readings of one call of the window, and whether the program's
    re-run picks the call's tokens again."""
    s0 = tokens.shape[1] - state.max_new
    logits, routes, picked = program_logits(state, tokens)
    out = readings((logits, routes), reference(state, tokens))
    out["rerun_token_diff"] = int((picked != tokens[:, s0:]).sum())
    return out


def summarise(calls: List[Dict[str, object]]) -> Dict[str, float]:
    errs = np.concatenate([c["errors"] for c in calls])
    return {"logit_err_median": float(np.median(errs)),
            "logit_err_p90": float(np.quantile(errs, 0.9)),
            "logit_err_max": float(errs.max()),
            "route_diff_share": (sum(c["route_differ"] for c in calls)
                                 / sum(c["route_choices"] for c in calls)),
            "positions": int(errs.size),
            "rerun_token_diff": sum(c.get("rerun_token_diff", 0)
                                    for c in calls)}


def check(state: State) -> Tuple[Dict[str, float], int]:
    calls = [compare(state, out) for out in state.outs]
    readings = summarise(calls)
    limits = state.cell.check["limits"]
    failed = int(any(readings[n] > lim for n, lim in limits.items()))
    return readings, failed
