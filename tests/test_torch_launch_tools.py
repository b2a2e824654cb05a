"""The LM zoo's launch tools against the reference's (ROADMAP A6b, A6c).

  * the partition-spec trees of the ten architectures, raw and aligned,
    params and caches, on both production meshes, and the train state's
    (kimi-k2's int8 moments), leaf for leaf;
  * ``plan_cell`` / ``choose_n_micro`` on 10 archs × 4 shapes × dp 16/32;
  * ``model_flops``, ``optimizer_cost``, ``wire_bytes`` and
    ``roofline_terms`` on the same inputs;
  * the dry-run's ``memory.argument_bytes`` of three cells byte for byte
    against the reference's live ``_cell(..., probes=False)`` (each
    package in a subprocess: the port's needs a fake 256-rank world, the
    reference's 512 fake XLA devices);
  * a dense reduced config's probes on a 4 × 2 fake mesh: the per-layer
    FLOPs the probes give, against the count derived from the shapes;
  * the report's tables and the splice into a markdown file;
  * ``--mode lm`` of both launchers.

The spec functions only read a mesh's axis names and sizes, so both
packages get a stand-in mesh here.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs.archs import ALL_ARCHS
from repro.configs.base import get_config as j_get_config
from repro.launch import report as j_report
from repro.launch import roofline as j_roofline
from repro.launch import shapes as j_shapes
from repro.launch import steps as j_steps
from repro.models.api import get_model_api as j_get_api

from repro_torch.configs.base import get_config
from repro_torch.distributed import shardings as sh
from repro_torch.launch import report, roofline, shapes, steps
from repro_torch.launch import update_experiments
from repro_torch.models.api import get_model_api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}


class StandInMesh:
    """Axis names and sizes, as both packages' spec functions read them
    (``axis_names`` / ``shape`` for the reference, ``mesh_dim_names`` /
    ``size(i)`` for the port)."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)
        self.mesh_dim_names = tuple(sizes)

    def size(self, dim=None):
        vals = list(self.shape.values())
        return int(np.prod(vals)) if dim is None else vals[dim]


def _norm(entry):
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_list(leaves):
    return [None if s is None else tuple(_norm(e) for e in s)
            for s in leaves]


def _j_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, JP)
                           or s is None)


def _j_shapes(api):
    return jax.eval_shape(lambda: api.init_params(jax.random.key(0)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_pspec_trees_equal_the_reference(arch, mesh_name):
    mesh = StandInMesh(MESHES[mesh_name])
    japi, tapi = j_get_api(j_get_config(arch)), get_model_api(
        get_config(arch))
    # raw trees, params and caches
    assert _spec_list(sh.spec_leaves(tapi.param_pspecs(mesh))) == \
        _spec_list(_j_leaves(japi.param_pspecs(mesh)))
    assert _spec_list(sh.spec_leaves(tapi.cache_pspecs(mesh))) == \
        _spec_list(_j_leaves(japi.cache_pspecs(mesh)))
    # aligned to the params' and the cache's shapes
    j_steps.set_mesh_for_alignment(mesh)
    steps.set_mesh_for_alignment(mesh)
    jp = j_steps.align_pspecs(_j_shapes(japi), japi.param_pspecs(mesh))
    tp = steps.align_pspecs(steps.param_shapes(tapi),
                            tapi.param_pspecs(mesh))
    assert _spec_list(sh.spec_leaves(tp)) == _spec_list(_j_leaves(jp))
    jc = j_steps.align_pspecs(
        jax.eval_shape(lambda: japi.init_cache(128, 32768)),
        japi.cache_pspecs(mesh))
    tc = steps.align_pspecs(tapi.init_cache(128, 32768, device="meta"),
                            tapi.cache_pspecs(mesh))
    assert _spec_list(sh.spec_leaves(tc)) == _spec_list(_j_leaves(jc))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "internlm2-1.8b",
                                  "zamba2-7b"])
def test_train_state_pspecs_equal_the_reference(arch):
    """kimi-k2 keeps int8 moments (QuantizedArray q, scale); the port's
    optimizer keys its moments by the params' paths, which list in the
    reference's leaf order."""
    mesh = StandInMesh(MESHES["single_pod"])
    japi, tapi = j_get_api(j_get_config(arch)), get_model_api(
        get_config(arch))
    j_steps.set_mesh_for_alignment(mesh)
    steps.set_mesh_for_alignment(mesh)
    js = j_steps.train_state_pspecs(
        japi, mesh, j_steps.abstract_train_state(japi))
    ts = steps.train_state_pspecs(tapi, mesh,
                                  steps.abstract_train_state(tapi))
    jl = _j_leaves(js)
    tl = sh.spec_leaves(ts.params) + sh.spec_leaves(ts.opt_state) + \
        sh.spec_leaves(ts.step)
    assert _spec_list(tl) == _spec_list(jl)
    if arch == "kimi-k2-1t-a32b":
        from repro_torch.optim.quantized_state import QuantizedArray
        m = ts.opt_state["m"]
        assert all(isinstance(v, QuantizedArray) for v in m.values())


@pytest.mark.parametrize("dp", [16, 32])
def test_plan_cell_equals_the_reference(dp):
    for arch in ALL_ARCHS:
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        for shape in shapes.ALL_SHAPES:
            assert dataclasses.asdict(shapes.plan_cell(tcfg, shape, dp)) \
                == dataclasses.asdict(j_shapes.plan_cell(jcfg, shape, dp))
            assert shapes.cell_is_skipped(tcfg, shape) == \
                j_shapes.cell_is_skipped(jcfg, shape)
            for bl in (1, 2, 8, 16):
                seq = shapes.SHAPES[shape]["seq"]
                assert shapes.choose_n_micro(tcfg, bl, seq) == \
                    j_shapes.choose_n_micro(jcfg, bl, seq)
    assert shapes.SHAPES == j_shapes.SHAPES


def test_model_flops_and_optimizer_cost_equal_the_reference():
    for arch in ALL_ARCHS:
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        for kind, b, s in (("train", 256, 4096), ("prefill", 32, 32768),
                           ("decode", 128, 32768)):
            assert roofline.model_flops(tcfg, b, s, kind) == \
                j_roofline.model_flops(jcfg, b, s, kind)
        for md in ("float32", "bfloat16", "int8"):
            assert roofline.optimizer_cost(tcfg.n_params(), 256, md) == \
                roofline.Cost(**dataclasses.asdict(
                    j_roofline.optimizer_cost(jcfg.n_params(), 256, md)))
        for n in (256, 512):
            assert roofline.slstm_extra_flops(tcfg, 32, 4096, n) == \
                j_roofline.slstm_extra_flops(jcfg, 32, 4096, n)
    stats = [{"op": op, "bytes": 1 << 20, "group_size": g}
             for op in ("all-gather", "reduce-scatter", "all-reduce",
                        "all-to-all", "collective-permute")
             for g in (1, 2, 16)]
    assert roofline.wire_bytes(stats) == j_roofline.wire_bytes(stats)


def test_roofline_terms_use_the_h100():
    hw = roofline.HW
    assert (hw["peak_flops"], hw["hbm_bw"], hw["wire_bw"]) == \
        (989.4e12, 3.35e12, 50e9)
    t = roofline.roofline_terms(roofline.Cost(flops=989.4e12,
                                              bytes=3.35e12 * 2,
                                              coll_bytes=25e9))
    assert t["dominant"] == "memory"
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["roofline_fraction"] == pytest.approx(0.5)


CELLS = [("internlm2-1.8b", "decode_32k", 1_647_781_924),
         ("granite-moe-3b-a800m", "train_4k", 268_915_332),
         ("xlstm-350m", "prefill_32k", 142_619_264)]


def _python(code: str, env_extra=None, timeout=600) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.update(env_extra or {})
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def port_dryrun_facts():
    """The port's side in one fresh interpreter (a fake 256-rank world,
    then a fake 8-rank one in a second): argument bytes of the three
    cells, and the probes of a reduced dense config on 4 × 2."""
    out = _python(f"""
        import json
        from repro_torch.configs.base import get_config
        from repro_torch.distributed import shardings as sh
        from repro_torch.launch import dryrun
        from repro_torch.launch.shapes import plan_cell
        from repro_torch.models.api import get_model_api
        mesh = dryrun._mesh_for(False)
        res = {{}}
        for arch, shape, _ in {CELLS!r}:
            import dataclasses
            cfg = get_config(arch)
            if shape.endswith("32k"):
                cfg = dataclasses.replace(cfg, attn_impl="scan")
            plan = plan_cell(cfg, shape, sh.dp_size(mesh))
            res[arch + "/" + shape] = dryrun.cell_argument_bytes(
                get_model_api(cfg), mesh, plan)
        print(json.dumps(res))
    """)
    arg_bytes = json.loads(out.strip().splitlines()[-1])
    out = _python("""
        import json
        from repro_torch.configs.base import get_config
        from repro_torch.launch import probes
        from repro_torch.launch.mesh import fake_world, make_test_mesh
        from repro_torch.launch.shapes import CellPlan
        from repro_torch.launch.smoke_configs import reduced_config
        fake_world(8)
        mesh = make_test_mesh(4, 2)
        cfg = reduced_config(get_config("internlm2-1.8b"))
        plan = CellPlan(arch=cfg.name, shape="p", kind="prefill", seq=64,
                        global_batch=8, n_micro=1, b_local=2)
        total, detail = probes.assemble_cell_cost(cfg, "p", mesh, plan)
        print(json.dumps(detail))
    """)
    detail = json.loads(out.strip().splitlines()[-1])
    return arg_bytes, detail


@pytest.fixture(scope="module")
def reference_argument_bytes():
    out = _python(f"""
        import json, os
        from repro.launch import dryrun
        res = {{}}
        for arch, shape, _ in {CELLS!r}:
            rec = dryrun._cell(arch, shape, False, "unused", probes=False)
            res[arch + "/" + shape] = rec["memory"]["argument_bytes"]
        print(json.dumps(res))
    """, env_extra={"JAX_PLATFORMS": "cpu"})
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape,want", CELLS)
def test_dryrun_argument_bytes_equal_the_reference(
        arch, shape, want, port_dryrun_facts, reference_argument_bytes):
    got = port_dryrun_facts[0][f"{arch}/{shape}"]
    assert got == reference_argument_bytes[f"{arch}/{shape}"] == want


def test_probes_per_layer_flops_match_the_shapes(port_dryrun_facts):
    """Reduced internlm2 (d 64, 4 heads of 16, 4 KV heads, d_ff 128) on
    a 4 × 2 mesh, prefill of 8 × 64: each rank holds 2 rows and half the
    heads and features, so a layer's matmuls are its local shards' and
    its attention visits 3 causal 32 × 32 blocks of 2 local heads."""
    detail = port_dryrun_facts[1]
    t = 2 * 64                       # local tokens
    d, half_heads, half_ff = 64, 32, 64
    proj = 2 * t * d * half_heads * 3 + 2 * t * half_heads * d
    mlp = 2 * t * d * half_ff * 2 + 2 * t * half_ff * d
    block = 2 * 2 * 2 * 32 * 32 * 16         # b, heads, q, k, hd
    attn = 3 * 2 * block                     # scores + values
    assert detail["layer"]["flops"] == proj + mlp + attn
    assert detail["multipliers"] == {"layer": 4}


def test_trace_replay_counts_what_a_full_trace_counts():
    """The dry-run's replay of identical local calls (``roofline``'s
    ``run_local``) gives the counts of a trace that runs every call:
    reduced internlm2 (4 layers) on a 4 × 2 fake mesh, prefill and
    decode, FLOPs, bytes, collectives, temp and output bytes, local and
    DTensor op counts equal, and the replay did replace calls."""
    out = _python("""
        import json
        from repro_torch.configs.base import get_config
        from repro_torch.launch import dryrun, roofline
        from repro_torch.launch.mesh import fake_world, make_test_mesh
        from repro_torch.launch.shapes import CellPlan
        from repro_torch.launch.smoke_configs import reduced_config
        from repro_torch.models.api import get_model_api
        fake_world(8)
        mesh = make_test_mesh(4, 2)
        api = get_model_api(reduced_config(get_config("internlm2-1.8b")))
        run_local = roofline._LocalOpMode.run_local
        hits = []

        def counting(self, fn, args):
            hits.append(self._memo_key(fn, args) in self.memo)
            return run_local(self, fn, args)

        def facts(kind, replay):
            plan = CellPlan(arch="x", shape=kind, kind=kind, seq=64,
                            global_batch=8, n_micro=1, b_local=2)
            _, tr = dryrun.trace_cell(api, mesh, plan, replay=replay)
            return [tr.cost.to_dict(), tr.collectives, tr.temp_bytes,
                    tr.output_bytes, tr.n_ops, tr.n_dtensor_ops]

        roofline._LocalOpMode.run_local = counting
        res = {}
        for kind in ("prefill", "decode"):
            hits.clear()
            res[kind] = {"replay": facts(kind, True), "hits": sum(hits)}
            n = len(hits)
            res[kind]["full"] = facts(kind, False)
            res[kind]["full_calls"] = len(hits) - n
        print(json.dumps(res))
    """)
    res = json.loads(out.strip().splitlines()[-1])
    for kind, r in res.items():
        assert r["hits"] >= 3, (kind, r["hits"])      # layers 2-4 at least
        assert r["full_calls"] == 0, kind             # nothing replayed
        assert r["replay"] == r["full"], kind


def test_trace_replay_keys_only_what_holds_its_state():
    """A local call is replayed only when every closure value is keyed
    by all of its state: plain values, containers of them by their
    contents, frozen configs by value; anything else (an object, a
    tensor) means it is always run."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import roofline

    cfg = get_config("internlm2-1.8b")
    opts = {"causal": True, "chunk": 32}

    def make(v):
        return lambda x: (x, v)

    k1 = roofline._closure_key(make(opts))
    opts["chunk"] = 64
    assert roofline._closure_key(make(opts)) not in (None, k1)
    assert roofline._closure_key(make((cfg, 3, "model"))) == \
        roofline._closure_key(make((cfg, 3, "model")))
    assert roofline._closure_key(make(object())) is None
    assert roofline._closure_key(make(torch.zeros(2))) is None
    assert roofline._closure_key(make([1, {"a": object()}])) is None


def _records():
    ok = dict(arch="a1", shape="train_4k", mesh="single_pod", status="ok",
              compile_seconds=12.3,
              memory=dict(resident_bytes=3 << 30, fits=True,
                          argument_bytes=1, temp_bytes=2),
              cost_full_hlo_once=dict(coll_count=7),
              roofline=dict(compute_s=1.5, memory_s=0.25,
                            collective_s=0.125, dominant="compute",
                            step_lower_bound_s=1.5, roofline_fraction=1.0,
                            useful_flops_ratio=0.5))
    return [ok,
            dict(arch="a2", shape="long_500k", mesh="single_pod",
                 status="skipped"),
            dict(arch="a3", shape="decode_32k", mesh="multi_pod",
                 status="error", error="x"),
            dict(ok, mesh="multi_pod", memory=dict(argument_bytes=1 << 30,
                                                   temp_bytes=1 << 30,
                                                   fits=False))]


HARDWARE_WORDS = [("256 × H100 80 GB", "256 chips"),
                  ("512 × H100 80 GB", "512 chips"),
                  ("fits 80 GB", "fits 16 GiB"), ("trace s", "compile s"),
                  ("collectives", "HLO colls")]


def _as_reference(text: str) -> str:
    for ours, theirs in HARDWARE_WORDS:
        text = text.replace(ours, theirs)
    return text


@pytest.mark.parametrize("mesh", ["single_pod", "multi_pod"])
def test_report_tables_equal_the_reference(mesh):
    recs = _records()
    assert _as_reference(report.dryrun_table(recs, mesh)) == \
        j_report.dryrun_table(recs, mesh)
    assert _as_reference(report.roofline_table(recs)) == \
        j_report.roofline_table(recs)


def test_report_reads_records_and_splices_them(tmp_path):
    art = tmp_path / "art"
    art.mkdir()
    for r in _records():
        (art / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(
            json.dumps(r))
    (art / "notes.json").write_text("{}")      # no '__': skipped
    recs = report.load(str(art))
    assert [r["arch"] for r in recs] == [r["arch"] for r in j_report.load(
        str(art))]
    doc = tmp_path / "EXP.md"
    doc.write_text("head\n<!-- BEGIN GENERATED DRYRUN TABLES (auto) -->\n"
                   "old\n<!-- END GENERATED DRYRUN TABLES -->\nmid\n"
                   "<!-- BEGIN GENERATED ROOFLINE TABLE -->\nold\n"
                   "<!-- END GENERATED ROOFLINE TABLE -->\ntail\n")
    update_experiments.main(["--art", str(art), "--path", str(doc)])
    text = doc.read_text()
    assert "old" not in text and text.startswith("head\n") and \
        text.endswith("tail\n")
    assert report.dryrun_table(recs, "single_pod") in text
    assert report.dryrun_table(recs, "multi_pod") in text
    assert report.roofline_table(recs) in text


def test_run_lm_lowers_the_loss_and_resumes_bitwise(tmp_path):
    from repro_torch.launch import train as launch_train
    from repro_torch.tree import leaves

    def args(workdir, steps):
        ns = launch_train.argparse.Namespace(
            arch="internlm2-1.8b", seed=0, workdir=str(workdir),
            steps=steps, batch_size=4, seq_len=16, ckpt_every=4,
            device="cpu")
        return ns

    full = launch_train.run_lm(args(tmp_path / "a", 8))
    assert full["last_loss"] < full["first_loss"]
    launch_train.run_lm(args(tmp_path / "b", 4))
    resumed = launch_train.run_lm(args(tmp_path / "b", 8))
    assert resumed["start_step"] == 4 and resumed["steps"] == 4
    assert resumed["losses"] == full["losses"][4:]
    assert all(torch.equal(x, y) for x, y in zip(
        leaves(full["state"]), leaves(resumed["state"])))


def test_serve_lm_equals_greedy_generate():
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.smoke_configs import reduced_config
    from repro_torch.serving import greedy_generate
    ns = launch_serve.argparse.Namespace(arch="qwen2-vl-2b", seed=3,
                                         max_batch=2, tokens=5,
                                         device="cpu")
    toks = launch_serve.serve_lm(ns)
    cfg = reduced_config(get_config("qwen2-vl-2b"))
    api = get_model_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(3), device="cpu")
    prompt = np.random.default_rng(3).integers(1, cfg.vocab, (2, 8)
                                               ).astype(np.int32)
    ve = torch.zeros(api.batch_shapes(2, 8)["vision_embeds"].shape)
    want = greedy_generate(api, params, prompt, max_new=5, max_len=13,
                           extras={"vision_embeds": ve}, device="cpu")
    assert toks.shape == (2, 13)
    assert np.array_equal(toks, want)
