"""Ground-truth draws of the Rosenbrock density from a long classic-NUTS run
(port of ``mcmc_tpu/targets/rosenbrock_reference.py``).

The density has no exact sampler. ``generate_rosenbrock_reference`` runs
the port's classic-NUTS warmup and ``nuts_run``, thins, and caches the
draws as ``.npy``; ``load_rosenbrock_reference`` reads them back. The cache
is the port's own directory, ``mcmc_tpu_torch/targets/reference_samples/``
(listed in ``.gitignore``: made at run time, never committed); a file made
elsewhere, the JAX package's shipped ``rosenbrock_20d.npy`` for one, is read
through ``path``.
"""

import os
import warnings
from typing import Optional

import numpy as np
import torch

CACHE_DIR = os.path.join(os.path.dirname(__file__), "reference_samples")


def cache_path(dim: int, scale: float = 0.1) -> str:
    """The cached draws' file: the JAX package's name at its scale 0.1,
    the scale in the name at any other."""
    suffix = "" if scale == 0.1 else f"_scale{scale}"
    return os.path.join(CACHE_DIR, f"rosenbrock_{dim}d{suffix}.npy")


def load_rosenbrock_reference(dim: int, scale: float = 0.1,
                              path: Optional[str] = None) -> Optional[torch.Tensor]:
    """The cached draws (n, dim) as a CPU tensor of the file's dtype, or
    None when there are none (with a warning at dim 20 and 50, the
    reference's two shipped sizes). `path` reads another file."""
    path = path or cache_path(dim, scale)
    if not os.path.exists(path):
        if dim in (20, 50):
            warnings.warn(f"Rosenbrock reference samples not found at {path}; "
                          f"generate_rosenbrock_reference({dim}) makes them", UserWarning)
        return None
    draws = torch.from_numpy(np.load(path))
    if draws.ndim != 2 or draws.shape[1] != dim:
        raise ValueError(f"{path} holds draws of shape {tuple(draws.shape)}, not (n, {dim})")
    return draws


def generate_rosenbrock_reference(dim: int, scale: float = 0.1, n_samples: int = 50000,
                                  n_chains: int = 32, num_warmup: int = 2000, seed: int = 7,
                                  thin: int = 4, path: Optional[str] = None,
                                  device="cuda", max_tree_depth: int = 12,
                                  verbose: bool = True, **warmup_kwargs) -> np.ndarray:
    """Draw and cache Rosenbrock ground truth with a long classic-NUTS run.

    `n_chains` chains from the target's init sampler go through the
    classic-NUTS windowed warmup (target accept 0.8, tree depth
    `max_tree_depth`), then nuts_run draws ceil(n_samples thin / n_chains)
    per chain; the draws are thinned by `thin`, the first `n_samples`
    kept, saved to `path` (default: the port's cache) and returned as a
    float32 (n_samples, dim) array. The split R-hat is printed. Runs on the
    card unless `device` names another; `warmup_kwargs` go to
    run_adaptive_warmup (exploration_steps, adaptation_windows,
    cooldown_steps) to cut the warmup."""
    from mcmc_tpu_torch.diagnostics import split_rhat
    from mcmc_tpu_torch.samplers.nuts import nuts_run
    from mcmc_tpu_torch.targets import rosenbrock
    from mcmc_tpu_torch.tuning.adaptation import run_adaptive_warmup

    target = rosenbrock(dim=dim, scale=scale)
    generator = torch.Generator(device=device).manual_seed(seed)
    init = target.init_sampler(generator, n_chains)
    step_size, inv_mass, position, _ = run_adaptive_warmup(
        "nuts", target.log_prob_fn, None, init, generator, num_warmup=num_warmup,
        target_accept=0.8, max_tree_depth=max_tree_depth,
        value_and_grad_fn=target.value_and_grad_fn, **warmup_kwargs)
    per_chain = (n_samples * thin + n_chains - 1) // n_chains
    res = nuts_run(generator, target.log_prob_fn, position, step_size=step_size,
                   num_samples=per_chain, inv_mass_matrix=inv_mass,
                   max_tree_depth=max_tree_depth, value_and_grad_fn=target.value_and_grad_fn)
    if verbose:
        rhat = float(torch.max(split_rhat(res.samples)))
        print(f"Rosenbrock {dim}D reference: R-hat max = {rhat:.4f}")
    flat = res.samples[::thin].reshape(-1, dim)[:n_samples].to(torch.float32).cpu().numpy()
    path = path or cache_path(dim, scale)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, flat)
    return flat
