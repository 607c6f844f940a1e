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
# (family, dim, n_chains, num_steps, schedule[, transitions], dense), host
# target params, host TargetData, scalars, key, call, q, lp, grad, inv_mass,
# l_inv, p0, u, seven outputs, stream
_SIGNATURES = {
    "grahmc_step_launch": [_I] * 6 + [_P, _P, _P, _P, _U] + [_P] * 7 + [_P] * 7 + [_P],
    "grahmc_multistep_launch": [_I] * 7 + [_P, _P, _P, _P, _U] + [_P] * 7 + [_P] * 7
                               + [_P],
    # (family, dim, n_chains, rung_chains, num_steps, schedule, dense), host
    # target params, host TargetData, rung table, key, call, the seven inputs
    # and outputs of grahmc_step_launch, stream
    "grahmc_scaled_launch": [_I] * 7 + [_P, _P, _P, _P, _U] + [_P] * 7 + [_P] * 7 + [_P],
    # (family, dim, n_chains, num_steps, schedule, dense), host target
    # params, host TargetData, scalars, base mean and 1/scale rows, key,
    # call, seven inputs, seven outputs, stream
    "grahmc_bridged_launch": [_I] * 6 + [_P] * 6 + [_U] + [_P] * 7 + [_P] * 7 + [_P],
    # (family, dim, n_chains, transitions, n_hist), host target params, host
    # TargetData, scale, key, call, q, lp, noise, u, five outputs, stream
    "rwmh_multistep_launch": [_I] * 5 + [_P, _P, _P, _P, _U] + [_P] * 4 + [_P] * 5
                             + [_P],
    # (family, dim, n_chains, n_iters, slots, max_tree_depth, multinomial,
    # dense), host target params, host TargetData, scalars, inv_mass, l_inv,
    # key, call, host arrays of the state and draw pointers, stream
    "nuts_window_launch": [_I] * 8 + [_P] * 6 + [_U, _P, _P, _P],
    # (dim, n_data, dense, data), out chains a block, out rows a tile
    "grahmc_tile_geometry": [_I] * 4 + [_P, _P],
    # (dim, dense), out chains a block, out rows a tile
    "nuts_tile_geometry": [_I] * 2 + [_P, _P],
    # (dim), out chains a block, out rows a tile
    "rwmh_tile_geometry": [_I] + [_P, _P],
}


class TargetParams(ctypes.Structure):
    """`struct TargetParams` of csrc/targets.cuh: a family's float
    parameters v, and the L1 families' shell radii and count."""
    _fields_ = [("v", ctypes.c_float * 8), ("shell", ctypes.c_float * 8),
                ("n_shells", ctypes.c_int)]


class TargetData(ctypes.Structure):
    """`struct TargetData` of csrc/targets.cuh: a data-carrying target's
    device pointers X (n_data, dim), xt (dim, n_data), y (n_data,)."""
    _fields_ = [("X", ctypes.c_void_p), ("xt", ctypes.c_void_p), ("y", ctypes.c_void_p),
                ("n_data", ctypes.c_int)]


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
    running at once, then link them into the shared library `out`. Each
    process writes its output to a file, so none waits on a full pipe.
    Returns the compilers' output (ptxas registers and spills per kernel)
    and each source's compile seconds."""
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f"{out.name}.{src.stem}.o") for src in sources]
    texts = [out.with_name(f"{out.name}.{src.stem}.log") for src in sources]
    t0 = time.perf_counter()
    procs = []
    for src, obj, text in zip(sources, objs, texts):
        with open(text, "w") as sink:
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                          stdout=sink, stderr=subprocess.STDOUT))
    seconds = {}
    while len(seconds) < len(procs):
        for src, proc in zip(sources, procs):
            if src.name not in seconds and proc.poll() is not None:
                seconds[src.name] = time.perf_counter() - t0
        time.sleep(0.05)
    logs, failed = [], []
    for src, proc, text in zip(sources, procs, texts):
        logs.append(f"[{src.name}] nvcc {seconds[src.name]:.1f} s\n{text.read_text()}")
        text.unlink(missing_ok=True)
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
