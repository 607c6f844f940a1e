"""Chain parallelism over a mesh of ranks (port of ``mcmc_tpu/parallel``).

MCMC chains are embarrassingly parallel: the sampling loops communicate
nothing, and only the tuners' feedback, SMC's weight reductions and the
final totals cross chains. The JAX package lays the chains out with a
``NamedSharding(P('chains'))`` over a 1-D device mesh and lets GSPMD (or an
explicit ``shard_map``) partition the programs. PyTorch has no partitioner,
so the port runs one process per rank over ``torch.distributed``:

- every rank holds the same global arrays where the JAX API takes them
  (each builds them from the same seed) and works on its contiguous block
  of the chain axis (``shard_chains``: rank r owns rows r C/n .. (r+1) C/n,
  the layout ``P('chains')`` gives);
- ``psum``, ``pmax``, ``pmean`` and ``all_gather`` are the collectives the
  JAX code writes as ``lax.psum`` / ``lax.pmax`` / ``lax.pmean`` and the
  gathers GSPMD inserts, on the mesh's process group;
- ``fold_generator`` gives each rank its own random stream, the
  counterpart of ``random.fold_in(key, lax.axis_index('chains'))``.

``constrain_chains`` and ``shard_map_fn`` are GSPMD machinery with no
PyTorch counterpart and are not ported.

Backend rule (``mesh_backend``): NCCL where each rank owns its own card;
gloo on the CPU; gloo for several ranks sharing one card, and only when the
caller asks for it (``backend="gloo"``). NCCL refuses two ranks on one GPU,
so a mesh that would need it raises instead of switching silently.
"""

from datetime import timedelta
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor

CHAIN_AXIS = "chains"
DEFAULT_TIMEOUT = timedelta(seconds=120)


class ChainMesh(NamedTuple):
    """A 1-D mesh of ranks over the chain axis, as seen by one rank.

    group: the process group of the collectives (None: a solo mesh, which
        runs none); rank and size: this rank's index in it and its ranks;
    device: this rank's torch.device; backend: "nccl", "gloo" or None;
    fold_index: the index this rank's random streams fold by (its rank; a
        solo mesh may stand in for any rank of a larger one)."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]
    fold_index: int


def _default_device(rank: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh runs on the card unless the "
                           "caller passes device='cpu'")
    return torch.device("cuda", rank % torch.cuda.device_count())


def mesh_backend(device, world_size: int, requested: Optional[str] = None) -> str:
    """The collectives' backend by the rule above. CPU ranks take gloo; CUDA
    ranks take NCCL, unless more ranks than cards would share one, which
    raises unless the caller asked for gloo."""
    device = torch.device(device)
    if requested not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {requested!r}; use 'nccl' or 'gloo'")
    if device.type == "cpu":
        if requested == "nccl":
            raise ValueError("NCCL carries CUDA tensors only; CPU ranks take gloo")
        return "gloo"
    shared = world_size > torch.cuda.device_count()
    if requested == "gloo":
        return "gloo"
    if shared:
        raise RuntimeError(
            f"{world_size} ranks on {torch.cuda.device_count()} card(s): NCCL refuses "
            "two ranks on one GPU; pass backend='gloo' to share a card")
    return "nccl"


def solo_mesh(device, fold_index: int = 0) -> ChainMesh:
    """A one-rank mesh without a process group, whose streams fold by
    `fold_index`: a 1-rank run over rank r's chains of a larger mesh."""
    return ChainMesh(None, 0, 1, torch.device(device), None, int(fold_index))


def make_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
              device=None) -> ChainMesh:
    """The chain mesh over every rank of the default process group, in rank
    order (``parallel.distributed.initialize`` creates it), as this rank
    sees it. Without a process group it is a solo mesh. n_devices, when
    given, must equal the group's size: one process is one rank. device
    defaults to the card cuda:(rank mod cards). The group's collectives run
    on `backend` (default: the default group's), checked by mesh_backend's
    rule; a backend other than the default group's gets a group of its own
    over the same ranks."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh of {n_devices} ranks needs as many processes; this "
                         f"job has {world} (run it under torchrun --nproc-per-node "
                         f"{n_devices})")
    device = _default_device(rank) if device is None else torch.device(device)
    if not initialized:
        return solo_mesh(device)
    # a group the caller joined with gloo stays gloo (asked for); NCCL on a
    # shared card raises in mesh_backend
    backend = mesh_backend(device, world, backend or dist.get_backend())
    group = dist.group.WORLD
    if dist.get_backend() != backend:
        group = dist.new_group(backend=backend, timeout=DEFAULT_TIMEOUT)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return ChainMesh(group, rank, world, device, backend, rank)


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, ChainMesh):
        raise TypeError(f"mesh must be a parallel.ChainMesh (parallel.make_mesh), "
                        f"got {type(mesh).__name__}")


def shard_chains(x: Tensor, mesh: ChainMesh) -> Tensor:
    """This rank's contiguous block of x's leading (chain) axis, on the
    rank's device; a 0-d tensor is replicated."""
    _check_mesh(mesh)
    if x.ndim == 0:
        return x.to(mesh.device)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} chains do not divide over {mesh.size} ranks")
    local = n // mesh.size
    return x[mesh.rank * local:(mesh.rank + 1) * local].to(mesh.device)


def replicate(x: Tensor, mesh: ChainMesh) -> Tensor:
    """x on this rank's device (every rank holds the whole of it)."""
    return x.to(mesh.device)


def psum(x: Tensor, mesh: ChainMesh) -> Tensor:
    """Sum of x over the mesh's ranks (lax.psum); x itself is left as it
    was. A solo mesh returns x."""
    if mesh.group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def pmax(x: Tensor, mesh: ChainMesh) -> Tensor:
    """Elementwise maximum of x over the mesh's ranks (lax.pmax)."""
    if mesh.group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out


def pmean(x: Tensor, mesh: ChainMesh) -> Tensor:
    """Mean of x over the mesh's ranks (lax.pmean): equal shards make the
    mean of the ranks' means the global mean."""
    return psum(x, mesh) / mesh.size if mesh.group is not None else x


def all_gather(x: Tensor, mesh: ChainMesh) -> Tensor:
    """Every rank's x concatenated along the leading axis in rank order (the
    global array of a chain-sharded one), on every rank.

    NCCL gathers on the card. gloo carries only broadcast and all_reduce
    for CUDA tensors, so under gloo the blocks are staged through the host:
    each rank copies its block to the CPU, gloo gathers the CPU blocks, and
    the result is copied back to the rank's device. The copies are exact."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    if mesh.backend == "nccl":
        out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return out
    host = x.cpu()
    blocks = [torch.empty_like(host) for _ in range(mesh.size)]
    dist.all_gather(blocks, host, group=mesh.group)
    return torch.cat(blocks).to(x.device)


_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_generator(generator: torch.Generator, index: int, device=None) -> torch.Generator:
    """Stream `index` of `generator` (random.fold_in): a new generator on
    `device` (default: the generator's), seeded by one draw of `generator`
    mixed with `index`.
    Every rank draws the same seed from its identical run generator, so
    stream r depends on the run's seed and on r alone, never on the mesh's
    size, and the run generator advances alike on every rank."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    child = torch.Generator(device=generator.device if device is None else device)
    child.manual_seed(_splitmix64(_splitmix64(seed) ^ int(index)))
    return child


def rank_generator(generator: torch.Generator, mesh: ChainMesh) -> torch.Generator:
    """This rank's stream of `generator`, on the rank's device."""
    _check_mesh(mesh)
    if torch.device(generator.device).type != mesh.device.type:
        raise ValueError(f"the run's generator lives on {generator.device}, the rank on "
                         f"{mesh.device}")
    return fold_generator(generator, mesh.fold_index, mesh.device)
