"""Build and bind the hand-written CUDA kernels of ``mcmc_tpu_torch/csrc``.

The kernels are compiled at first use with ``nvcc`` for Hopper (sm_90a) into
one shared library with a plain C interface, loaded with ``ctypes``: every
``csrc/*.cu`` is compiled to an object by its own ``nvcc`` process, all
started together, and the objects are linked into one library. The library
lands in ``mcmc_tpu_torch/_build/`` under a name carrying a hash of the
sources and flags, so an edit to any source builds a new one. Nothing here
runs at import time: the CPU tests import every module on hosts with no
``nvcc`` and no GPU.

No ``--use_fast_math``: the kernels' isfinite energy guard and the agreement
of expf/logf/sinf/cosf with the plain PyTorch version depend on IEEE math.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# (family, dim, n_chains, num_steps, schedule[, transitions]), scalars, key,
# call, q, lp, grad, inv_mass, p0, u, seven outputs, stream
_SIGNATURES = {
    "grahmc_step_launch": [_I] * 5 + [_P, _P, _U] + [_P] * 6 + [_P] * 7 + [_P],
    "grahmc_multistep_launch": [_I] * 6 + [_P, _P, _U] + [_P] * 6 + [_P] * 7
                               + [_P],
    # (family, dim, n_chains, transitions, n_hist), scale, key, call, q, lp,
    # noise, u, five outputs, stream
    "rwmh_multistep_launch": [_I] * 5 + [_P, _P, _U] + [_P] * 4 + [_P] * 5
                             + [_P],
    # (family, dim, n_chains, n_iters, slots, max_tree_depth), scalars,
    # inv_mass, key, call, host arrays of the state and draw pointers, stream
    "nuts_window_launch": [_I] * 6 + [_P, _P, _P, _U, _P, _P, _P],
}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float      # 0.0 when the library was already built
    build_log: str            # nvcc/ptxas output (registers, spills) or ""


_LOADED = []      # the process's loaded library: ctypes handles are process-wide


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME); the fused CUDA "
                       "kernels are built from mcmc_tpu_torch/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> str:
    """Compile every csrc/*.cu to an object, one nvcc process per source, all
    running at once, then link them into the shared library `out`. Returns
    the compilers' output (ptxas registers and spills per kernel)."""
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f"{out.name}.{src.stem}.o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        text = proc.communicate()[0]
        logs.append(f"[{src.name}]\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "".join(logs)
    if not failed:
        link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                               "-shared", "-o", str(out), *map(str, objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    return log


def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library; later calls
    in the process return the loaded one without touching the disk."""
    if _LOADED:
        return _LOADED[0]
    so = BUILD_DIR / f"libmcmc_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        log = _compile(nvcc, tmp)
        seconds = time.perf_counter() - t0
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOADED.append(KernelLibrary(lib, so, seconds, log))
    return _LOADED[0]
