"""The paper's b-bit hashing as LM embedding compression, on the PyTorch
port; ``examples/lm_hashed_embeddings.py`` on ``repro_torch``.

A reduced internlm2-family decoder is trained twice on the same
synthetic token stream: once with a dense (vocab × d) embedding, once
with the b-bit hashed embedding (k tables of 2^b rows — the paper's
n·b·k storage argument applied to the embedding matrix).  Losses track
each other while the hashed table is a fraction of the dense size.
Both models start from the same seeded ``torch.Generator``; ``--device
cpu`` runs on the CPU.

Run:  PYTHONPATH=src python examples/lm_hashed_embeddings_torch.py
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.data.lm_synth import lm_example_stream
from repro_torch.devices import resolve_device
from repro_torch.launch.smoke_configs import reduced_config
from repro_torch.models.api import get_model_api
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.steps import build_train_step, init_state


def train(cfg, device, steps=60, batch=8, seq=64, seed=0):
    api = get_model_api(cfg)
    opt = make_optimizer("adamw", 3e-3)
    params = api.init_params(torch.Generator().manual_seed(seed),
                             device=device)
    state = init_state(params, opt)
    step_fn = build_train_step(lambda p, b_: api.loss_fn(p, b_), opt)
    losses = []
    for step, toks, tgts in lm_example_stream(batch, seq, cfg.vocab,
                                              seed=seed):
        if step >= steps:
            break
        state, loss = step_fn(state, {
            "tokens": torch.from_numpy(toks).to(device),
            "targets": torch.from_numpy(tgts).to(device)})
        losses.append(float(loss))
    return losses, state


def embed_params_size(state) -> int:
    return sum(t.numel() for t in state.params["embed"].values())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    dev = resolve_device(args.device)

    base = dataclasses.replace(reduced_config(get_config("internlm2-1.8b")),
                               vocab=8192)
    hashed = dataclasses.replace(base, embedding="bbit_hash", hash_k=8,
                                 hash_b=8)
    print("training dense-embedding model…")
    l_dense, s_dense = train(base, dev, steps=args.steps)
    print("training bbit-hashed-embedding model…")
    l_hash, s_hash = train(hashed, dev, steps=args.steps)
    n_dense = embed_params_size(s_dense)
    n_hash = embed_params_size(s_hash)
    print(f"\nembedding params: dense={n_dense / 1e3:.0f}k "
          f"hashed={n_hash / 1e3:.0f}k "
          f"({n_dense / max(n_hash, 1):.1f}× compression)")
    print(f"final loss: dense={np.mean(l_dense[-10:]):.3f} "
          f"hashed={np.mean(l_hash[-10:]):.3f}")
    print("loss curves (every 10 steps):")
    for i in range(0, len(l_dense), 10):
        print(f"  step {i:3d}: dense={l_dense[i]:.3f} "
              f"hashed={l_hash[i]:.3f}")
    if not all(np.isfinite(l_dense + l_hash)):
        raise SystemExit("a loss is not finite")
    if not (l_dense[-1] < l_dense[0] and l_hash[-1] < l_hash[0]):
        raise SystemExit("a loss did not fall")


if __name__ == "__main__":
    main()
