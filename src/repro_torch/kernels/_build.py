"""Builds the CUDA sources in ``repro_torch/csrc`` and loads them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/repro_torch_kernels/`` at the root of the checkout that holds
the package (the directory with ``pyproject.toml`` and
``src/repro_torch``), and loaded with ``ctypes``.  A copy of the package
outside a checkout has nowhere of its own to build, so it raises.  The file name carries a digest of the sources and
flags, so an edited source is rebuilt and a stale library never loads.
``build()`` starts one ``nvcc`` per source, all at once.  A failed
build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
# exported C functions of each library: name -> argtypes (restype int)
SIGNATURES: Dict[str, Dict[str, List]] = {
    "fused_encode": {
        "repro_minhash_pack": [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                               P],
        "repro_oph_pack": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                           I, P],
    },
    "bbit_linear": {
        "repro_bbit_linear_packed_fwd": [P, P, P, P, I, I, I, I, I, I, I,
                                         I, I, I, I, P],
        "repro_bbit_linear_fwd": [P, P, P, P, I, I, I, I, I, I, I, I, I, P],
        "repro_bbit_linear_dw_plan": [P, P, P, P, P, P, P, I, I, I, I, I,
                                      P],
        "repro_bbit_linear_dw_sum": [P, P, P, P, P, I, I, I, I, I, I, I, I,
                                     P],
        "repro_bbit_linear_packed_bwd_dw": [P, P, P, P, I, I, I, I, I, I, I,
                                            I, I, I, I, I, P],
    },
    "vw_sketch": {
        "repro_vw_sketch": [P, P, P, P, I, I, I, I, I, U, I, P],
    },
    "minhash": {
        "repro_minhash": [P, P, P, P, P, I, I, I, I, P],
    },
    "oph": {
        "repro_oph": [P, P, P, P, P, I, I, I, I, I, P],
    },
    "hamming": {
        "repro_hamming_distance": [P, P, P, I, I, I, I, I, I, I, I, P],
    },
    "launch_floor": {
        "repro_empty_launch": [P, P, P, P, P, P, I, I, I, I, P],
    },
}
ERROR_FN = {name: f"repro_{name}_error" for name in SIGNATURES}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    """``build/repro_torch_kernels`` under the checkout holding this
    package; raises when the package does not lie in a checkout."""
    for root in PACKAGE.parents:
        if ((root / "pyproject.toml").is_file()
                and (root / "src" / "repro_torch").resolve() == PACKAGE):
            return root / "build" / "repro_torch_kernels"
    raise RuntimeError(f"{PACKAGE} is not in a checkout of the repository "
                       "(no pyproject.toml above src/repro_torch): nowhere "
                       "to build the CUDA kernels")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compiles the named libraries (all by default) that are not built
    yet, one ``nvcc`` each, in parallel.  → {name: seconds} for the ones
    it compiled; ptxas's register report lands beside each library."""
    with _lock:
        return _build(list(SIGNATURES if names is None else names))


def _build(names: List[str]) -> Dict[str, float]:
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            err = getattr(lib, ERROR_FN[name])
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(name: str, code: int, what: str) -> None:
    """Raises if a launcher returned a CUDA error."""
    if code != 0:
        msg = getattr(load(name), ERROR_FN[name])(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def on_cpu(what: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (→ the plain version), False for a CUDA
    tensor (→ the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return False


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def l2_bytes(index: int) -> int:
    """Bytes of L2 cache of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).L2_cache_size


def stream(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
