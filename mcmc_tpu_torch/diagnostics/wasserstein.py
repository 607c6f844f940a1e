"""Sliced Wasserstein-2 distance (port of
``mcmc_tpu/diagnostics/wasserstein.py``).

The reference's protocol (metrics.py:12-145, run_benchmarks.py:817-820):
500 random unit projections, quantile matching when the sample counts
differ, W2 = sqrt(mean((q1 - q2)^2)) per projection, the mean over
projections; ``compute_sliced_w2`` flattens the chains, draws 50,000
exact reference draws and subsamples the MCMC side when it is larger.
Projection is one matmul and a sort along the samples, on the samples'
device, in float64 where either side is; the projections are laid out
(P, n), so that each projection sorts as one contiguous row.

The random directions, reference draws and subsample come from an explicit
``torch.Generator`` (seeded 30 for the directions and 123 for the
reference by default, as the JAX package's default keys); every function
also takes the directions (and the tracker and ``compute_sliced_w2`` the
reference draws) as arguments, so that a caller can inject the JAX
package's. The JAX package's ``_unshard`` has no counterpart: a history
here lives on one device.
"""

from typing import Optional

import torch

Tensor = torch.Tensor

DEFAULT_DIRECTION_SEED = 30
DEFAULT_REFERENCE_SEED = 123


def _seeded(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def unit_directions(generator: torch.Generator, n: int, dim: int) -> Tensor:
    """(n, dim) float64 directions uniform on the unit sphere."""
    d = torch.randn((n, dim), generator=generator, device=generator.device,
                    dtype=torch.float64)
    return d / torch.linalg.norm(d, dim=1, keepdim=True)


def _flat(samples: Tensor, dim: int) -> Tensor:
    samples = torch.as_tensor(samples)
    return samples.reshape(-1, dim) if samples.ndim == 3 else samples


def _common(*xs: Tensor):
    """The tensors on the first one's device, in float64 where any is."""
    dtype = torch.float64 if any(x.dtype == torch.float64 for x in xs) else xs[0].dtype
    return [x.to(device=xs[0].device, dtype=dtype) for x in xs]


def quantiles_of_sorted(s: Tensor, n_quantiles: int) -> Tensor:
    """Linear-interpolated quantiles at linspace(0, 1, n_quantiles) of the
    already sorted rows of a (P, n) matrix (jnp.quantile's default
    interpolation, without its re-sort)."""
    n = s.shape[1]
    pos = torch.linspace(0.0, 1.0, n_quantiles, dtype=torch.float64, device=s.device) * (n - 1)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = (pos - lo).to(s.dtype)
    return s[:, lo] * (1.0 - frac) + s[:, hi] * frac


def _sorted_projections(samples: Tensor, directions: Tensor) -> Tensor:
    """(P, n): each direction's projections of the samples, sorted."""
    return torch.sort(directions @ samples.T, dim=1).values


def _w2_of_sorted(s1: Tensor, s2: Tensor) -> Tensor:
    """W2 of each projection (P,) from sorted (P, n1) and (P, n2) rows,
    quantile-matched at min(n1, n2) points when the counts differ."""
    if s1.shape[1] != s2.shape[1]:
        n_q = min(s1.shape[1], s2.shape[1])
        s1, s2 = quantiles_of_sorted(s1, n_q), quantiles_of_sorted(s2, n_q)
    return torch.sqrt(torch.mean((s1 - s2) ** 2, dim=1))


def sliced_wasserstein_distance(samples1, samples2, n_projections: int = 500,
                                generator: Optional[torch.Generator] = None,
                                projection_batch_size: int = 500,
                                directions: Optional[Tensor] = None) -> float:
    """Sliced W2 between two sample sets (n_i, dim).

    directions: (n_projections, dim) unit rows to project on; by default
    each batch of `projection_batch_size` is drawn from `generator`
    (seeded DEFAULT_DIRECTION_SEED on the samples' device when None).
    """
    samples1, samples2 = _common(torch.as_tensor(samples1), torch.as_tensor(samples2))
    dim = samples1.shape[1]
    if directions is None and generator is None:
        generator = _seeded(DEFAULT_DIRECTION_SEED, samples1.device)
    w2 = []
    for start in range(0, n_projections, projection_batch_size):
        size = min(projection_batch_size, n_projections - start)
        dirs = (unit_directions(generator, size, dim) if directions is None
                else torch.as_tensor(directions)[start:start + size])
        dirs = dirs.to(device=samples1.device, dtype=samples1.dtype)
        w2.append(_w2_of_sorted(_sorted_projections(samples1, dirs),
                                _sorted_projections(samples2, dirs)))
    return float(torch.mean(torch.cat(w2)))


def _subsample(flat: Tensor, n: int, generator: torch.Generator) -> Tensor:
    """n rows drawn without replacement."""
    idx = torch.randperm(flat.shape[0], generator=generator, device=generator.device)[:n]
    return flat[idx.to(flat.device)]


class ConvergenceW2Tracker:
    """Sliced W2 of a convergence trace against one cached reference.

    The reference draws and the directions are drawn once (in that order,
    from `generator`) and the sorted reference projections cached, so each
    checkpoint pays only its own projection and sort, and checkpoints share
    their directions. Given a generator, the tracker draws them at once on
    its device; without one, at the first checkpoint, from a generator
    seeded DEFAULT_REFERENCE_SEED on that checkpoint's device. A checkpoint
    is projected and sorted where its samples lie (the cache follows them
    there, never the other way). A checkpoint with more draws than the
    reference is subsampled from the same generator, whose state
    (``self.generator``) a resumed run restores. ``ok`` is False for a
    target without an exact sampler.
    """

    def __init__(self, target_name: str, dim: int, n_reference: int = 50000,
                 n_projections: int = 500, generator: Optional[torch.Generator] = None,
                 reference: Optional[Tensor] = None, directions: Optional[Tensor] = None,
                 **target_kwargs):
        from mcmc_tpu_torch.targets import get_reference_sampler
        self._ref_sampler = get_reference_sampler(target_name, dim, **target_kwargs)
        self.ok = self._ref_sampler is not None
        self.generator = generator
        self._dim, self._n_reference, self._n_projections = dim, n_reference, n_projections
        self._reference, self._directions = reference, directions
        self._ref_sorted = None
        if self.ok and generator is not None:
            self._draw(generator.device)

    def _draw(self, device) -> None:
        if self.generator is None:
            self.generator = _seeded(DEFAULT_REFERENCE_SEED, device)
        ref = (self._ref_sampler(self.generator, self._n_reference)
               if self._reference is None else self._reference)
        dirs = (unit_directions(self.generator, self._n_projections, self._dim)
                if self._directions is None else self._directions)
        ref, self._dirs = _common(torch.as_tensor(ref), torch.as_tensor(dirs))
        self._ref_sorted = _sorted_projections(ref, self._dirs)
        self._n_ref = ref.shape[0]

    def w2(self, samples) -> Optional[float]:
        """Sliced W2 of (draws, chains, dim) or (n, dim) samples, or None."""
        if not self.ok:
            return None
        flat = _flat(samples, self._dim)
        if self._ref_sorted is None:
            self._draw(flat.device)
        if flat.shape[0] > self._n_ref:
            flat = _subsample(flat, self._n_ref, self.generator)
        if self._dirs.device != flat.device:
            self._dirs = self._dirs.to(flat.device)
            self._ref_sorted = self._ref_sorted.to(flat.device)
        s1 = _sorted_projections(flat.to(self._dirs.dtype), self._dirs)
        return float(torch.mean(_w2_of_sorted(s1, self._ref_sorted)))


def compute_sliced_w2(samples, target_name: str, dim: int, n_reference: int = 50000,
                      n_projections: int = 500, projection_batch_size: int = 500,
                      generator: Optional[torch.Generator] = None,
                      reference: Optional[Tensor] = None,
                      directions: Optional[Tensor] = None, **target_kwargs) -> Optional[float]:
    """Sliced W2 between MCMC samples ((S, C, dim) or (n, dim)) and the
    target's exact draws, or None where it has no exact sampler. From
    `generator` (seeded DEFAULT_REFERENCE_SEED on the samples' device when
    None), in this order: the reference draws (unless given), the
    subsample of a larger sample set, the directions (unless given)."""
    from mcmc_tpu_torch.targets import get_reference_sampler

    ref_sampler = get_reference_sampler(target_name, dim, **target_kwargs)
    if ref_sampler is None:
        return None
    flat = _flat(samples, dim)
    if generator is None:
        generator = _seeded(DEFAULT_REFERENCE_SEED, flat.device)
    if reference is None:
        reference = ref_sampler(generator, n_reference)
    if flat.shape[0] > n_reference:
        flat = _subsample(flat, n_reference, generator)
    return sliced_wasserstein_distance(flat, reference, n_projections=n_projections,
                                       generator=generator,
                                       projection_batch_size=projection_batch_size,
                                       directions=directions)
