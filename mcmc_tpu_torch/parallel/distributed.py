"""Process-group initialization and the global chain mesh (port of
``mcmc_tpu/parallel/distributed.py``).

Chains communicate nothing while sampling, so a multi-process run is pure
data parallelism over the chain axis: one process per rank, each owning a
block of the chains, joined by ``torch.distributed``.

`initialize()` wraps ``torch.distributed.init_process_group`` (a no-op for
one process); `make_chain_mesh()` builds the 1-D chain mesh over every rank
of the group in rank order. The JAX package's hybrid DCN x ICI ordering has
no single-node counterpart: ranks are processes, ordered by rank.
"""

import os
from typing import Optional

import torch
import torch.distributed as dist

from mcmc_tpu_torch.parallel import (DEFAULT_TIMEOUT, ChainMesh, make_mesh,
                                     mesh_backend)

# Environment evidence that this process is part of a multi-process job
# (torchrun sets these). When one is set, a failed argument-free
# initialize() must NOT fall back to one process: each process would run
# an independent duplicate job.
_DIST_ENV_HINTS = ("MASTER_ADDR", "TORCHELASTIC_RUN_ID")


def _multi_process_env() -> bool:
    if any(os.environ.get(v) for v in _DIST_ENV_HINTS):
        return True
    try:
        return int(os.environ.get("WORLD_SIZE", "1")) > 1
    except ValueError:
        return True


def initialize(init_method: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None) -> int:
    """Join the process group; returns this process's rank.

    init_method: a rendezvous URL (``tcp://host:port``, ``file://path``) or
    the JAX package's coordinator address "host:port", read as
    ``tcp://host:port``. With no arguments the environment's rendezvous
    (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) is used. One
    process (num_processes <= 1) is a no-op returning 0.

    backend follows ``parallel.mesh_backend`` for `device` (default: the
    card when there is one, else the CPU): NCCL where each rank owns a card,
    gloo on the CPU or, when asked for, on a shared card. DEFAULT_TIMEOUT
    bounds the rendezvous and every gloo collective, so a dead rank fails
    the run instead of hanging it.

    Only two failures may proceed as one process: the group already exists,
    or the call had no arguments and nothing in the environment says there
    is a multi-process job. Every other failure re-raises."""
    if num_processes is not None and num_processes <= 1:
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    no_args = init_method is None and num_processes is None and process_id is None
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    kwargs = {"timeout": DEFAULT_TIMEOUT}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    try:
        world = int(num_processes if num_processes is not None
                    else os.environ.get("WORLD_SIZE", "1"))
        dist.init_process_group(backend=mesh_backend(device, world, backend), **kwargs)
    except (ValueError, RuntimeError) as e:
        already = "already" in str(e).lower()
        if not (already or (no_args and not _multi_process_env())):
            raise
        return 0
    return dist.get_rank()


def make_chain_mesh(backend: Optional[str] = None, device=None) -> ChainMesh:
    """The global 1-D chain mesh over every rank of the default group, in
    rank order (a solo mesh when there is no group)."""
    return make_mesh(backend=backend, device=device)
