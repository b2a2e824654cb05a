"""The port's package surface against the reference's (ROADMAP A8).

  * each package's ``__init__`` re-exports every name of the reference's
    ``__all__`` under the same name (the LM zoo's since ROADMAP A6a);
    the reference's jnp paths have their torch twins;
  * ``optim.schedules.make`` and ``data.packing.batch_iterator``, copies
    of the reference's, against it;
  * ``kernels.ref``: the plain versions under the reference oracles'
    names and signatures, against those oracles;
  * the four examples with a torch twin, each in a fresh interpreter on
    the CPU at its smallest size;
  * ``distributed``'s ``__all__`` and the public names of every
    ``launch`` module (read from the reference's source: importing its
    dry-run sets XLA flags), the HLO readers mapped to the port's trace
    readers (ROADMAP A6b, A6c).
"""
import ast
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.kernels.ref as jref
from repro.data import packing as jpacking
from repro.optim import schedules as jsched

from repro_torch.core.universal_hash import int32_to_words
from repro_torch.data import packing as tpacking
from repro_torch.kernels import ref as tref
from repro_torch.optim import schedules as tsched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("optim", "train", "data", "core", "ft", "configs", "kernels",
            "serving")
# names of the reference's __all__s that belong to ROADMAP A6's modules:
# none since A6a brought train/steps.py's microbatched LM step,
# data/lm_synth.py and configs/base.py
A6_NAMES = set()
# the reference's jnp paths and their torch twins
RENAMED = {"minhash_jnp": "minhash_torch",
           "oph_bin_minima_jnp": "oph_bin_minima_torch"}


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_follow_the_reference(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = {n for n in ref.__all__ if not hasattr(port, n)}
    assert missing <= A6_NAMES | set(RENAMED), missing - A6_NAMES
    for name in missing & set(RENAMED):
        assert RENAMED[name] in port.__all__
    assert all(hasattr(port, n) for n in port.__all__)
    assert {n for n in ref.__all__ if hasattr(port, n)} <= set(port.__all__)


def test_the_missing_names_are_a6s():
    missing = set()
    for package in PACKAGES:
        ref = importlib.import_module(f"repro.{package}")
        port = importlib.import_module(f"repro_torch.{package}")
        missing |= {n for n in ref.__all__ if not hasattr(port, n)}
    assert missing == A6_NAMES | set(RENAMED)


def test_importing_a_package_builds_no_kernel():
    """A fresh interpreter imports every package and reads an export of
    each; no kernel library is loaded."""
    code = ("import repro_torch.kernels._build as b\n"
            + "".join(f"import repro_torch.{p} as m; m.__all__ and "
                      f"getattr(m, m.__all__[0])\n" for p in PACKAGES)
            + "assert not b._libs, b._libs\n"
            "import sys; assert 'jax' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.mark.parametrize("name", ["constant", "warmup_cosine",
                                  "inverse_sqrt"])
def test_schedule_make_matches_reference(name):
    want = jsched.make(name, 0.05, total_steps=120, warmup_steps=10)
    got = tsched.make(name, 0.05, total_steps=120, warmup_steps=10)
    for step in (0, 1, 5, 9, 10, 11, 60, 119, 120, 200):
        np.testing.assert_allclose(
            float(got(torch.tensor(step, dtype=torch.int32))),
            float(want(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-7)
    defaults = tsched.make(name, 0.1)
    np.testing.assert_allclose(float(defaults(torch.tensor(150))),
                               float(jsched.make(name, 0.1)(150)),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown schedule"):
        tsched.make("linear", 0.1)


@pytest.mark.parametrize("seed,drop", [(None, True), (3, True), (3, False)])
def test_batch_iterator_matches_reference(seed, drop):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 1 << 20, size=(37, 9)).astype(np.int32)
    nnz = rng.integers(1, 10, size=37).astype(np.int32)
    labels = rng.integers(0, 2, size=37).astype(np.int32)
    want = list(jpacking.batch_iterator(idx, nnz, labels, 8,
                                        shuffle_seed=seed,
                                        drop_remainder=drop))
    got = list(tpacking.batch_iterator(idx, nnz, labels, 8,
                                       shuffle_seed=seed,
                                       drop_remainder=drop))
    assert len(got) == len(want) == (4 if drop else 5)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b) and a.dtype == b.dtype


def test_kernels_ref_matches_the_reference_oracles():
    from repro.core.universal_hash import MultiplyShiftHash as JHash
    from repro_torch.core.universal_hash import MultiplyShiftHash
    from repro_torch.core.bbit import pack_codes
    rng = np.random.default_rng(1)
    n, m, k, bits = 12, 30, 16, 4
    idx = rng.integers(0, 1 << 30, size=(n, m)).astype(np.int32)
    nnz = rng.integers(0, m + 1, size=n).astype(np.int32)
    ja, jb = JHash.make(k, 1).params()
    ta, tb = MultiplyShiftHash.make(k, 1).params("cpu")
    got = int32_to_words(tref.minhash(torch.from_numpy(idx),
                                      torch.from_numpy(nnz), ta, tb))
    want = np.asarray(jref.minhash(jnp.asarray(idx), jnp.asarray(nnz), ja,
                                   jb))
    assert np.array_equal(np.asarray(got), want)
    codes = rng.integers(0, 1 << bits, size=(n, k)).astype(np.int32)
    table = rng.normal(size=(k, 1 << bits, 2)).astype(np.float32)
    dout = rng.normal(size=(n, 2)).astype(np.float32)
    empty = np.packbits(rng.random((n, k)) < 0.3, axis=1)
    packed = pack_codes(codes.astype(np.uint16), bits)
    t = torch.from_numpy
    pairs = [
        (tref.bbit_linear_fwd(t(codes), t(table)),
         jref.bbit_linear_fwd(jnp.asarray(codes), jnp.asarray(table))),
        (tref.bbit_linear_bwd_dw(t(codes), t(dout), 1 << bits),
         jref.bbit_linear_bwd_dw(jnp.asarray(codes), jnp.asarray(dout),
                                 1 << bits)),
        (tref.bbit_linear_packed_fwd(t(packed), t(table), k, bits,
                                     empty=t(empty)),
         jref.bbit_linear_packed_fwd(jnp.asarray(packed), jnp.asarray(table),
                                     k, bits, empty=jnp.asarray(empty))),
        (tref.bbit_linear_packed_bwd_dw(t(packed), t(dout), 1 << bits, k,
                                        bits, empty=t(empty)),
         jref.bbit_linear_packed_bwd_dw(jnp.asarray(packed),
                                        jnp.asarray(dout), 1 << bits, k,
                                        bits, empty=jnp.asarray(empty))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    np.testing.assert_allclose(
        tref.vw_sketch(t(idx), t(vals), t(nnz), 64, 2).numpy(),
        np.asarray(jref.vw_sketch(jnp.asarray(idx), jnp.asarray(vals),
                                  jnp.asarray(nnz), 64, 2)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
def test_hash_evals_per_nonzero_match_reference(scheme):
    from repro_torch.core.schemes import make_scheme
    assert (make_scheme(scheme, 64, 1).hash_evals_per_nonzero
            == jcore.make_scheme(scheme, 64, 1).hash_evals_per_nonzero)


# each example at its smallest size on the CPU (about 5-11 s each here)
EXAMPLES = {
    "quickstart_torch.py": ["--n-docs", "160", "--k", "32",
                            "--calibrate-budget-s", "1"],
    "oph_preprocess_torch.py": ["--n-docs", "160", "--k", "32"],
    "serve_classifier_torch.py": ["--n-docs", "280", "--k", "32"],
    "stream_train_torch.py": ["--n-docs", "360", "--k", "32"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name),
         "--device", "cpu", *EXAMPLES[name]],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(os.path.join(ROOT, "examples", name)) as f:
        source = f.read()
    assert "from repro." not in source and "import jax" not in source


# the reference's readers of XLA's compiled programs, and the port's
# readers of a traced call (launch/roofline.py::trace_step)
TRACE_NAMES = {"collective_stats_from_hlo": "collective_stats_from_trace",
               "collective_bytes_from_hlo": "collective_bytes_from_trace",
               "cost_of_compiled": "cost_of_trace"}


def test_distributed_exports_follow_the_reference():
    import repro.distributed as ref
    import repro_torch.distributed as port
    missing = {n for n in ref.__all__ if not hasattr(port, n)}
    assert missing == {"collective_stats_from_hlo",
                       "collective_bytes_from_hlo"}
    for name in missing:
        assert TRACE_NAMES[name] in port.__all__
    assert all(hasattr(port, n) for n in port.__all__)


def _public_names(path: str) -> set:
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


REF_LAUNCH = os.path.join(ROOT, "src", "repro", "launch")


@pytest.mark.parametrize("module", sorted(
    f[:-3] for f in os.listdir(REF_LAUNCH)
    if f.endswith(".py") and f != "__init__.py"))
def test_launch_module_names_follow_the_reference(module):
    port = importlib.import_module(f"repro_torch.launch.{module}")
    for name in _public_names(os.path.join(REF_LAUNCH, module + ".py")):
        assert hasattr(port, TRACE_NAMES.get(name, name)), name


def test_every_reference_module_has_a_counterpart():
    ref_root = os.path.join(ROOT, "src", "repro")
    port_root = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(ref_root):
        rel = os.path.relpath(dirpath, ref_root)
        for f in files:
            if f.endswith(".py"):
                assert os.path.exists(os.path.join(port_root, rel, f)), \
                    os.path.join(rel, f)
