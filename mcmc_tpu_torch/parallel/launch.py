"""Run a function on every rank of a local chain mesh, one process a rank.

    results = run_ranks("path/to/file.py:function", world=2, timeout=120)

(or RankRun(...) to start them, and .results() later to wait for them)

starts `world` Python processes (``python -m mcmc_tpu_torch.parallel.launch``,
one thread each), which join one process group through a ``FileStore``
rendezvous in a temporary directory (no network), build the mesh
(``parallel.make_mesh`` on `device` with `backend`; `device` defaults to
the card, cuda:(rank mod cards), and raises without one unless the caller
passes device="cpu"), call
``function(mesh)`` and save its result (a dict of tensors, numbers and
lists) with ``torch.save``. It
returns the ranks' results in rank order. A rank that fails, or a run that
passes `timeout` seconds, kills every rank and raises RuntimeError with the
ranks' output: a dead rank fails the run instead of hanging it.

The target names a file and a function in it (or ``module:function``); the
processes run from the current directory with the repository on their path.
"""

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]


def _load(target: str):
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem + "_on_rank", where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


class RankRun:
    """`world` rank processes running `target(mesh)`, started on
    construction; `results()` waits for them (see the module docstring)."""

    def __init__(self, target: str, world: int, device=None, backend: Optional[str] = None,
                 timeout: float = 120.0):
        self.target, self.world, self.timeout = target, world, timeout
        if device is None:
            from mcmc_tpu_torch.parallel import _default_device
            device = _default_device(0).type            # raises without a card
        self.tmp = tempfile.mkdtemp(prefix="mesh_")
        spec = {"target": target, "world": world, "device": str(device), "backend": backend,
                "timeout": timeout, "rendezvous": os.path.join(self.tmp, "store")}
        spec_path = os.path.join(self.tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
            OMP_NUM_THREADS="1")
        self.logs = [open(os.path.join(self.tmp, f"rank{r}.log"), "w+") for r in range(world)]
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen([sys.executable, "-m", "mcmc_tpu_torch.parallel.launch",
                                        spec_path, str(r)], stdout=log,
                                       stderr=subprocess.STDOUT, env=env)
                      for r, log in enumerate(self.logs)]

    def results(self) -> list:
        """The ranks' results in rank order; kills every rank and raises
        RuntimeError when one fails or the time limit passes."""
        try:
            while any(p.poll() is None for p in self.procs):
                if (time.monotonic() > self.deadline
                        or any(p.poll() not in (None, 0) for p in self.procs)):
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        try:
            codes = [p.returncode for p in self.procs]
            outputs = []
            for log in self.logs:
                log.seek(0)
                outputs.append(log.read())
                log.close()
            if any(c != 0 for c in codes):
                text = "\n".join(f"--- rank {r} (exit {c}) ---\n{o[-4000:]}"
                                 for r, (c, o) in enumerate(zip(codes, outputs)))
                raise RuntimeError(f"{self.target} on {self.world} ranks failed "
                                   f"(limit {self.timeout:.0f} s):\n{text}")
            import torch
            results = [torch.load(os.path.join(self.tmp, f"rank{r}.pt"), weights_only=False)
                       for r in range(self.world)]
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        for res, out in zip(results, outputs):
            if isinstance(res, dict):
                res.setdefault("output", out)
        return results


def run_ranks(target: str, world: int, device=None, backend: Optional[str] = None,
              timeout: float = 120.0) -> list:
    """Run `target(mesh)` on `world` ranks; returns their results in rank
    order (see the module docstring)."""
    return RankRun(target, world, device, backend, timeout).results()


def _rank_main(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from mcmc_tpu_torch.parallel import make_mesh, mesh_backend

    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    world, device = spec["world"], spec["device"]
    backend = mesh_backend(device, world, spec["backend"])
    dist.init_process_group(backend, store=dist.FileStore(spec["rendezvous"], world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=spec["timeout"]))
    try:
        mesh = make_mesh(world, backend=backend, device=None if device == "cuda" else device)
        result = _load(spec["target"])(mesh)
        torch.save(result, os.path.join(os.path.dirname(spec_path), f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
