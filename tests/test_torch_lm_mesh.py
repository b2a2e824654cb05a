"""The LM zoo on a mesh against the reference's multi-device runs
(ROADMAP A6c).

The reference runs once, in a subprocess with 8 fake XLA devices: its
own inits (the weights), and on its meshes (``launch/mesh.py``'s, whose
axes are Auto as in its tests and dry-run) MoE expert parallelism
(2×2×2, with ample capacity and with drops at capacity 1),
weight-stationary serving (4×2), the paper's linear step (4×2, three
AdamW steps from a random table), and reduced LMs: internlm2 and
granite-moe on 4×2, and on 2×4 an internlm2 with 4 query heads and 2 KV
heads ('gqa': 'model' divides the first, not the second) and one with 6
heads padded to shard over model=4 ('pad', ``attn_pad_heads``).  Each
LM gives its loss, prefill, three decode steps (on 2×4 from a cache
sharded over its sequence) and, but 'pad', one ``build_lm_train_step``
step at n_micro 2 (the backward on the mesh).  It pickles inputs,
weights and outputs.

The port runs once, as a gang of 8 processes over gloo (one rank a
device), on the same inputs and weights, on DeviceMeshes of the same
shapes and axis names, and on one process without a mesh; rank 0
pickles its outputs.  The tests compare them at the tolerances of the
reference's own tests: 1e-4 for the MoE dispatches, 1e-5 for the linear
step's loss, tests/test_models_numerics.py's 1e-4 for the reduced
models, tests/test_torch_lm_models.py's 1e-4 of each leaf's largest for
gradients.
"""
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LMS = ("internlm2-1.8b", "granite-moe-3b-a800m")
# the 2×4 cases: 4 query heads / 2 KV heads, and 6 heads padded
CASES = LMS + ("gqa", "pad")
# the cases without MoE capacity drops, held to the mesh-free run too
NOMESH = ("internlm2-1.8b", "gqa", "pad")

REFERENCE = r"""
import pickle, sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ArchConfig, get_config
import repro.models.moe as M
from repro.launch.mesh import _make_mesh
out = {}

def put(tree, mesh, specs):
    return jax.device_put(tree, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda s: isinstance(s, P)))

# --- MoE expert parallelism on (pod, data, model) = 2x2x2 -------------
M.EXPERT_PAD_TO = 2
mesh = _make_mesh((2, 2, 2), ("pod", "data", "model"))
x = np.random.default_rng(0).normal(size=(4, 8, 16)).astype("f")
out["moe_x"] = x
for cap in (8.0, 1.0):
    cfg = ArchConfig(name="m", family="moe", n_layers=1, d_model=16,
                     n_heads=2, n_kv_heads=2, d_ff=0, vocab=64,
                     moe_experts=6, moe_top_k=2, moe_d_ff=32,
                     moe_capacity=cap, dtype="float32")
    params = M.init_moe_params(cfg, jax.random.key(0), jnp.float32)
    out[f"moe_params"] = jax.tree.map(np.asarray, params)
    out[f"moe_dense_{cap}"] = np.asarray(M.moe_ffn(jnp.asarray(x), params,
                                                   cfg, mesh=None))
    ps = M.moe_param_pspecs(cfg, dp_axes=("pod", "data"))
    y = jax.jit(lambda a, b: M.moe_ffn(a, b, cfg, mesh=mesh))(
        jax.device_put(jnp.asarray(x), NamedSharding(
            mesh, P(("pod", "data"), None, None))), put(params, mesh, ps))
    out[f"moe_ep_{cap}"] = np.asarray(y)

# --- weight-stationary serving dispatch on 4x2 -------------------------
M.EXPERT_PAD_TO = 8
mesh = _make_mesh((4, 2), ("data", "model"))
cfg = ArchConfig(name="m", family="moe", n_layers=1, d_model=16,
                 n_heads=2, n_kv_heads=2, d_ff=0, vocab=64,
                 moe_experts=6, moe_top_k=2, moe_d_ff=32,
                 moe_capacity=8.0, dtype="float32",
                 moe_serving_dispatch="weight_stationary", moe_pad_to=8)
params = M.init_moe_params(cfg, jax.random.key(0), jnp.float32)
out["ws_params"] = jax.tree.map(np.asarray, params)
ps = M.moe_param_pspecs(cfg, dp_axes=("data",))
y = jax.jit(lambda a, b: M.moe_ffn(a, b, cfg, mesh=mesh, serving=True))(
    jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None,
                                                         None))),
    put(params, mesh, ps))
out["ws"] = np.asarray(y)
M.EXPERT_PAD_TO = 16

# --- the paper's linear step on 4x2 ------------------------------------
from repro.configs.rcv1_bbit import PaperConfig
from repro.launch.steps import build_linear_train_step
from repro.models.linear import BBitLinearConfig, init_bbit_linear
from repro.optim.optimizers import adamw, AdamWConfig
from repro.train.steps import TrainState
paper = PaperConfig(k=16, b=4, global_batch=32)
jitted, _, _, _ = build_linear_train_step(paper, mesh)
lcfg = BBitLinearConfig(k=16, b=4, use_kernel="never")
p0 = init_bbit_linear(lcfg, jax.random.key(1))
out["lin_params"] = jax.tree.map(np.asarray, p0)
state = TrainState(p0, adamw(1e-2, AdamWConfig()).init(p0),
                   jnp.zeros((), jnp.int32))
rng = np.random.default_rng(0)
codes = rng.integers(0, 16, (32, 16)).astype("i4")
labels = (rng.random(32) > .5).astype("i4")
out["lin_codes"], out["lin_labels"] = codes, labels
losses = []
with mesh:
    for _ in range(3):
        state, loss = jitted(state, jnp.asarray(codes), jnp.asarray(labels))
        losses.append(float(loss))
out["lin_losses"] = np.asarray(losses)
out["lin_final"] = jax.tree.map(np.asarray, state.params)

# --- reduced LMs: loss, prefill, decode and one train step ------------
from repro.launch.smoke_configs import reduced_config
from repro.launch import steps as S
from repro.launch.shapes import CellPlan
from repro.models.api import get_model_api

def lm_run(cfg, mesh, key, toks, tg, n_prompt, train):
    # loss, prefill of the first n_prompt tokens, three decode steps
    # and, if asked, one build_lm_train_step step at n_micro 2
    api = get_model_api(cfg)
    params = api.init_params(jax.random.key(key))
    b, t = toks.shape
    S.set_mesh_for_alignment(mesh)
    pp = S.align_pspecs(jax.eval_shape(lambda: params), api.param_pspecs(mesh))
    dparams = put(params, mesh, pp)
    bsh = NamedSharding(mesh, P("data", None))
    loss = jax.jit(lambda p, b: api.loss_fn(p, b, mesh))(
        dparams, {"tokens": jax.device_put(toks, bsh),
                  "targets": jax.device_put(tg, bsh)})
    lg, cache = jax.jit(lambda p, b: api.prefill(p, b, mesh))(
        dparams, {"tokens": jax.device_put(toks[:, :n_prompt], bsh)})
    full = api.init_cache(b, t)
    cache = jax.tree.map(lambda f, c: jax.lax.dynamic_update_slice_in_dim(
        f, c.astype(f.dtype), 0, axis=2), full, cache)
    cps = S.align_pspecs(jax.eval_shape(lambda: full), api.cache_pspecs(mesh))
    cache = put(cache, mesh, cps)
    dec = jax.jit(lambda p, b, c, n: api.decode_step(p, b, c, n, mesh))
    logits = []
    for pos in range(n_prompt, n_prompt + 3):
        lt, cache = dec(dparams, {"token": jax.device_put(
            toks[:, pos:pos + 1], bsh)}, cache, jnp.asarray(pos, jnp.int32))
        logits.append(np.asarray(lt))
    res = dict(params=jax.tree.map(np.array, params), tokens=toks,
               targets=tg, loss=float(loss), prefill=np.asarray(lg),
               decode=np.stack(logits))
    if train:
        plan = CellPlan(arch=cfg.name, shape="train", kind="train", seq=t,
                        global_batch=b, n_micro=2,
                        b_local=b // mesh.shape["data"])
        step, _, sps, _, bps = S.build_lm_train_step(api, mesh, plan)
        opt = S.make_optimizer_for(cfg)
        state = jax.device_put(
            TrainState(params, opt.init(params), jnp.zeros((), jnp.int32)),
            S.to_shardings(mesh, sps))
        batch = jax.device_put({"tokens": toks, "targets": tg},
                               S.to_shardings(mesh, bps))
        state, tl = step(state, batch)
        leaves = lambda tr: [np.asarray(x) for x in jax.tree.leaves(tr)]
        res["train"] = dict(loss=float(tl), params=leaves(state.params),
                            m=leaves(state.opt_state["m"]))
    return res

for arch in ("internlm2-1.8b", "granite-moe-3b-a800m"):
    cfg = reduced_config(get_config(arch))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (8, 36)).astype(np.int32)
    tg = rng.integers(0, cfg.vocab, (8, 36)).astype(np.int32)
    out[arch] = lm_run(cfg, mesh, 0, toks, tg, 32, True)
# --- on 2x4: query heads that 'model' divides and KV heads it does not
# (4 and 2), and 6 heads padded to shard over it (attn_pad_heads); both
# decode from a cache sharded over its sequence ------------------------
mesh = _make_mesh((2, 4), ("data", "model"))
base = reduced_config(get_config("internlm2-1.8b"))
rng = np.random.default_rng(7)
toks = rng.integers(0, base.vocab, (4, 24)).astype(np.int32)
tg = rng.integers(0, base.vocab, (4, 24)).astype(np.int32)
out["gqa"] = lm_run(dataclasses.replace(base, n_heads=4, n_kv_heads=2),
                    mesh, 3, toks, tg, 16, True)
rng = np.random.default_rng(6)
toks = rng.integers(0, base.vocab, (4, 24)).astype(np.int32)
tg = rng.integers(0, base.vocab, (4, 24)).astype(np.int32)
out["pad"] = lm_run(dataclasses.replace(base, n_heads=6, n_kv_heads=2,
                                        attn_pad_heads=True),
                    mesh, 2, toks, tg, 16, False)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

PORT = r"""
import os, pickle, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, world, port, ref_path, out_path):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import ArchConfig, get_config
    from repro_torch.distributed import shardings as sh
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.smoke_configs import reduced_config
    from repro_torch.models import moe as M
    from repro_torch.models.api import get_model_api, params_from_jax
    from repro_torch.train.steps import init_state
    from repro_torch.tree import leaves, paths, tree_map
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    out = {}
    t = lambda a: torch.from_numpy(np.array(a))
    full = lambda d: d.full_tensor().numpy()
    # --- MoE expert parallelism on 2x2x2 ---------------------------------
    M.EXPERT_PAD_TO = 2          # as the reference's run sets it
    mesh3 = init_device_mesh("cpu", (2, 2, 2),
                             mesh_dim_names=("pod", "data", "model"))
    x = t(ref["moe_x"])
    for cap in (8.0, 1.0):
        cfg = ArchConfig(name="m", family="moe", n_layers=1, d_model=16,
                         n_heads=2, n_kv_heads=2, d_ff=0, vocab=64,
                         moe_experts=6, moe_top_k=2, moe_d_ff=32,
                         moe_capacity=cap, dtype="float32")
        params = {k: t(v) for k, v in ref["moe_params"].items()}
        out[f"moe_dense_{cap}"] = M.moe_ffn(x, params, cfg).numpy()
        ps = M.moe_param_pspecs(cfg, dp_axes=("pod", "data"))
        dp = {k: sh.distribute(v, mesh3, ps[k]) for k, v in params.items()}
        with sh.implicit_replication():
            y = M.moe_ffn(sh.distribute(x, mesh3, sh.P(("pod", "data"))),
                          dp, cfg, mesh3)
        out[f"moe_ep_{cap}"] = full(y)
    # --- weight-stationary on 4x2 -----------------------------------------
    M.EXPERT_PAD_TO = 8          # as the reference's run sets it
    mesh = make_test_mesh(4, 2)
    cfg = ArchConfig(name="m", family="moe", n_layers=1, d_model=16,
                     n_heads=2, n_kv_heads=2, d_ff=0, vocab=64,
                     moe_experts=6, moe_top_k=2, moe_d_ff=32,
                     moe_capacity=8.0, dtype="float32",
                     moe_serving_dispatch="weight_stationary", moe_pad_to=8)
    params = {k: t(v) for k, v in ref["ws_params"].items()}
    ps = M.moe_param_pspecs(cfg, dp_axes=("data",))
    dp = {k: sh.distribute(v, mesh, ps[k]) for k, v in params.items()}
    with sh.implicit_replication():
        y = M.moe_ffn(sh.distribute(x, mesh, sh.P("data")), dp, cfg, mesh,
                      serving=True)
    out["ws"] = full(y)
    M.EXPERT_PAD_TO = 16
    # --- the paper's linear step on 4x2 -----------------------------------
    from repro_torch.configs.rcv1_bbit import PaperConfig
    from repro_torch.optim.optimizers import AdamWConfig, adamw
    paper = PaperConfig(k=16, b=4, global_batch=32)
    step, _, sps, _ = S.build_linear_train_step(paper, mesh)
    p0 = {k: t(v) for k, v in ref["lin_params"].items()}
    state = S.shard_tree(init_state(p0, adamw(1e-2, AdamWConfig())), sps,
                         mesh)
    codes = sh.distribute(t(ref["lin_codes"]), mesh, sh.P("data"))
    labels = sh.distribute(t(ref["lin_labels"]), mesh, sh.P("data"))
    losses = []
    for _ in range(3):
        state, loss = step(state, codes, labels)
        losses.append(float(full(loss)))
    out["lin_losses"] = np.asarray(losses)
    out["lin_final"] = {k: full(v) for k, v in state.params.items()}
    # --- reduced LMs: loss, prefill, decode, one train step ------------
    from repro_torch.launch.shapes import CellPlan
    from repro_torch.train.steps import build_microbatched_train_step
    bs = sh.P("data")

    def lm_run(cfg, mesh, r, n_prompt, train, nomesh):
        # the reference's lm_run on the port, on the mesh and (where
        # nomesh) without one
        api = get_model_api(cfg)
        params = params_from_jax(r["params"], cfg, "cpu")
        toks, tg = t(r["tokens"]), t(r["targets"])
        b, seq = toks.shape
        S.set_mesh_for_alignment(mesh)
        pp = S.align_pspecs(params, api.param_pspecs(mesh))
        dparams = S.shard_tree(params, pp, mesh)
        res = {"loss": float(full(api.loss_fn(
            dparams, {"tokens": sh.distribute(toks, mesh, bs),
                      "targets": sh.distribute(tg, mesh, bs)}, mesh)))}
        if nomesh:
            res["loss_nomesh"] = float(api.loss_fn(
                params, {"tokens": toks, "targets": tg}))
        with torch.no_grad():
            lg, cache = api.prefill(
                dparams, {"tokens": sh.distribute(toks[:, :n_prompt], mesh,
                                                  bs)}, mesh)
            res["prefill"] = full(lg)
            lg0, cache0 = api.prefill(params, {"tokens": toks[:, :n_prompt]})
            res["prefill_nomesh"] = lg0.numpy()

            def grow(f, c):
                f[:, :, :c.shape[2]] = c.full_tensor() if sh.is_dtensor(
                    c) else c
                return f
            cache = tree_map(grow, api.init_cache(b, seq, device="cpu"),
                             cache)
            cache0 = tree_map(grow, api.init_cache(b, seq, device="cpu"),
                              cache0)
            cps = S.align_pspecs(cache, api.cache_pspecs(mesh))
            dcache = S.shard_tree(cache, cps, mesh)
            dec, dec0 = [], []
            for pos in range(n_prompt, n_prompt + 3):
                tok = toks[:, pos:pos + 1]
                lt, dcache = api.decode_step(
                    dparams, {"token": sh.distribute(tok, mesh, bs)},
                    dcache, pos, mesh)
                dec.append(full(lt))
                l0, cache0 = api.decode_step(params, {"token": tok},
                                             cache0, pos)
                dec0.append(l0.numpy())
        res["decode"], res["decode_nomesh"] = np.stack(dec), np.stack(dec0)
        if not train:
            return res
        plan = CellPlan(arch=cfg.name, shape="train", kind="train", seq=seq,
                        global_batch=b, n_micro=2,
                        b_local=b // sh.axis_size(mesh, "data"))
        step, _, sps, _, bps = S.build_lm_train_step(api, mesh, plan)
        opt = S.make_optimizer_for(cfg)
        state = S.shard_tree(init_state(tree_map(torch.clone, params), opt),
                             sps, mesh)
        state, tl = step(state, S.shard_tree({"tokens": toks, "targets": tg},
                                             bps, mesh))
        names = paths(state.params)
        res["train"] = {
            "loss": float(full(tl)),
            "params": [full(x) for x in leaves(state.params)],
            "m": [full(state.opt_state["m"][n]) for n in names]}
        if nomesh:
            # the mesh-free step: the batch's halves in order, where each
            # mesh rank splits its own rows (the same mean, summed in
            # another order)
            mstep = build_microbatched_train_step(
                lambda p, bt: api.loss_fn(p, bt), opt, 2)
            st0 = init_state(tree_map(torch.clone, params), opt)
            st0, l0 = mstep(st0, {"tokens": toks, "targets": tg})
            res["train_nomesh"] = {
                "loss": float(l0),
                "m": [st0.opt_state["m"][n].numpy() for n in names]}
        return res

    for arch in ("internlm2-1.8b", "granite-moe-3b-a800m"):
        # MoE capacity drops where the mesh-free model does not
        out[arch] = lm_run(reduced_config(get_config(arch)), mesh, ref[arch],
                           32, True, arch == "internlm2-1.8b")
    # --- 2x4: 4 query heads / 2 KV heads, and 6 heads padded --------------
    mesh24 = make_test_mesh(2, 4)
    base = reduced_config(get_config("internlm2-1.8b"))
    out["gqa"] = lm_run(dataclasses.replace(base, n_heads=4, n_kv_heads=2),
                        mesh24, ref["gqa"], 16, True, True)
    out["pad"] = lm_run(dataclasses.replace(base, n_heads=6, n_kv_heads=2,
                                            attn_pad_heads=True),
                        mesh24, ref["pad"], 16, False, True)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run, args=(8, int(sys.argv[1]), sys.argv[2], sys.argv[3]),
             nprocs=8)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh")
    ref_path, port_path = str(d / "ref.pkl"), str(d / "port.pkl")
    env = _env(JAX_PLATFORMS="cpu", XLA_FLAGS=os.environ.get(
        "XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, ref_path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    script = d / "port.py"
    script.write_text(textwrap.dedent(PORT))
    proc = subprocess.run([sys.executable, str(script), str(_free_port()),
                           ref_path, port_path], capture_output=True,
                          text=True, timeout=600, env=_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    with open(port_path, "rb") as f:
        port = pickle.load(f)
    return ref, port


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("cap", [8.0, 1.0])
def test_moe_expert_parallel_matches_the_reference(runs, cap):
    """Expert parallelism on (pod, data, model) = 2×2×2: equal to the
    reference's; at ample capacity also to the dense fallback, at
    capacity 1 tokens are dropped (the two differ)."""
    ref, port = runs
    assert _err(port[f"moe_ep_{cap}"], ref[f"moe_ep_{cap}"]) < 1e-4
    assert _err(port[f"moe_dense_{cap}"], ref[f"moe_dense_{cap}"]) < 1e-4
    if cap == 8.0:
        assert _err(port["moe_ep_8.0"], port["moe_dense_8.0"]) < 1e-4
    else:
        assert _err(ref["moe_ep_1.0"], ref["moe_dense_1.0"]) > 1e-3


def test_moe_weight_stationary_matches_the_reference(runs):
    ref, port = runs
    assert _err(port["ws"], ref["ws"]) < 1e-4


def test_linear_step_matches_the_reference(runs):
    ref, port = runs
    assert _err(port["lin_losses"], ref["lin_losses"]) < 1e-5
    for k in ("table", "bias"):
        assert _err(port["lin_final"][k], ref["lin_final"][k]) < 1e-5


@pytest.mark.parametrize("arch", LMS + ("gqa",))
def test_reduced_lm_loss_matches_the_reference(runs, arch):
    ref, port = runs
    assert abs(port[arch]["loss"] - ref[arch]["loss"]) < 1e-4
    if arch in NOMESH:
        # no MoE capacity: the mesh computes what one device does
        assert abs(port[arch]["loss"] - port[arch]["loss_nomesh"]) < 1e-5


@pytest.mark.parametrize("arch", CASES)
def test_reduced_lm_prefill_matches_the_reference(runs, arch):
    ref, port = runs
    assert port[arch]["prefill"].shape == ref[arch]["prefill"].shape
    assert _err(port[arch]["prefill"], ref[arch]["prefill"]) < 1e-4
    if arch in NOMESH:
        assert _err(port[arch]["prefill"],
                    port[arch]["prefill_nomesh"]) < 1e-4


@pytest.mark.parametrize("arch", CASES)
def test_reduced_lm_decode_matches_the_reference(runs, arch):
    """Three decode steps.  On 2×4 ('gqa', 'pad') the 2 KV heads do not
    divide model=4, so the cache is sharded over its sequence and each
    step merges four ranks' partial softmax stats."""
    ref, port = runs
    assert _err(port[arch]["decode"], ref[arch]["decode"]) < 1e-4
    if arch in NOMESH:
        assert _err(port[arch]["decode"],
                    port[arch]["decode_nomesh"]) < 1e-4


@pytest.mark.parametrize("arch", LMS + ("gqa",))
def test_reduced_lm_train_step_matches_the_reference(runs, arch):
    """One build_lm_train_step step at n_micro 2 (AdamW, lr 3e-4), the
    backward on the mesh: FSDP gathers reduce-scattering their
    gradients over 'data', the vocab-parallel cross-entropy, MoE expert
    parallelism (granite-moe) and, on 2×4 ('gqa': 4 query heads over
    model=4, 2 KV heads), attention's KV gradients summed over 'model'
    (``grad_partial``).

    The first moment is (1 − b1)·g, g the mean of the microbatches'
    gradients: each leaf within 1e-4 of its largest, the gradient
    tolerance of tests/test_torch_lm_models.py.  AdamW's first update is
    lr·g/(|g| + eps), the sign of g, so the params are held within 1e-5
    where the reference's |g| is above 1e-3 of its leaf's largest (there
    a gradient cannot change its sign) and those must be most of the
    params; a gradient summed twice over an axis passes this check and
    fails the moment's."""
    ref, port = runs
    r, p = ref[arch]["train"], port[arch]["train"]
    assert abs(p["loss"] - r["loss"]) < 1e-4
    assert len(p["m"]) == len(r["m"])
    held = total = 0
    for pm, rm, pp, rp in zip(p["m"], r["m"], p["params"], r["params"]):
        scale = float(np.abs(rm).max())
        assert scale > 0
        assert _err(pm, rm) <= 1e-4 * scale
        keep = np.abs(rm) > 1e-3 * scale
        assert _err(pp[keep], rp[keep]) < 1e-5
        held += int(keep.sum())
        total += keep.size
    assert held > 0.4 * total, (held, total)
    if arch in NOMESH:
        q = port[arch]["train_nomesh"]
        assert abs(p["loss"] - q["loss"]) < 1e-5
        for pm, qm in zip(p["m"], q["m"]):
            assert _err(pm, qm) <= 1e-4 * float(np.abs(qm).max())


def test_head_padding_for_tp_matches_the_reference(runs):
    """6 heads on model=4 (``attn_pad_heads``): the query groups padded
    to shard over 'model', the loss the reference's and the mesh-free
    one."""
    ref, port = runs
    assert abs(port["pad"]["loss"] - ref["pad"]["loss"]) < 1e-4
    assert abs(port["pad"]["loss"] - port["pad"]["loss_nomesh"]) < 1e-5
