"""The JAX package on the CPU, at a cut, through the protocol chip_smoke.py's
[5o] phase runs on the port: the witness that says which of those cells the
reference itself passes, and so which the phase gates.

    JAX_PLATFORMS=cpu python experiments/torch_rahmc_witness.py \
        [--chains 64] [--draws 2000] [--cells rosenbrock10 multimodal ...]

Cells (the canonical matrix's protocol, results_full_matrix_native/README.md,
with its 2,500-step warmup; chains and draws cut):
- rosenbrock10: the 10-D Rosenbrock (scale 0.1) under GRAHMC with the dense
  learned metric, linear friction, L = 64 (the matrix's passing arm), RWMH
  (dual_averaging_tune_rwmh, then rwmh_run from the initial positions, as
  the runner does) and persistent NUTS (the persistent warmup with the dense
  metric, depth 15; 64 slots a draw, depth 10); R-hat only (no exact mean);
- rosenbrock20: GRAHMC as above on the 20-D Rosenbrock, its means against
  the shipped long-NUTS draws (mcmc_tpu/targets/reference_samples/
  rosenbrock_20d.npy, 32 chains thinned by 4: their MCSE from bulk ESS);
- multimodal, concentric, nested: the RAHMC paper's multimodal_funnel_2d
  (means against 10^6 exact draws), concentric_l1_2d and nested_l1_2d (true
  mean 0 by symmetry) under GRAHMC (diagonal learned metric, constant
  friction, L = 16), RWMH and persistent NUTS (diagonal).
Each run prints split R-hat, the means' largest z against the reference by
the chains' spread and by sd / sqrt(bulk ESS), the largest |chain mean -
reference mean| and each family's mode occupancy (the funnel: the share of
draws with v > 0; the L1 shells: the share on each shell, nearest radius of
the centre whose shell the draw sits nearest), overall and one chain's
extremes.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu.samplers import grahmc_run, nuts_run_persistent, rwmh_run  # noqa: E402
from mcmc_tpu.samplers.grahmc import default_steepness, get_friction_schedule  # noqa: E402
from mcmc_tpu.targets import get_reference_sampler, get_target  # noqa: E402
from mcmc_tpu.tuning import dual_averaging_tune_rwmh, run_adaptive_warmup  # noqa: E402
from mcmc_tpu_torch.diagnostics import ess_bulk, split_rhat  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (get_target name, dim, samplers, GRAHMC metric, schedule, L)
CELLS = {
    "rosenbrock10": ("rosenbrock", 10, ("grahmc", "rwmh", "nuts"), "dense", "linear", 64),
    "rosenbrock20": ("rosenbrock", 20, ("grahmc",), "dense", "linear", 64),
    "multimodal": ("multimodal_funnel_2d", 2, ("grahmc", "rwmh", "nuts"), True, "constant", 16),
    "concentric": ("concentric_l1_2d", 2, ("grahmc", "rwmh", "nuts"), True, "constant", 16),
    "nested": ("nested_l1_2d", 2, ("grahmc", "rwmh", "nuts"), True, "constant", 16),
}


def reference(name, dim):
    """(mean, MCSE) of the cell's reference, or None (Rosenbrock 10-D)."""
    if name == "rosenbrock":
        if dim != 20:
            return None
        draws = np.load(os.path.join(REPO, "mcmc_tpu", "targets", "reference_samples",
                                     "rosenbrock_20d.npy"))
        # rows are draw-major over the run's 32 chains (the last draw's
        # row cut short at 50,000)
        n = draws.shape[0] // 32 * 32
        x = torch.from_numpy(draws[:n]).double().reshape(-1, 32, dim)
        return x.mean(dim=(0, 1)), x.std(dim=(0, 1)) / torch.sqrt(ess_bulk(x).double())
    if name == "multimodal_funnel_2d":
        x = torch.from_numpy(np.asarray(get_reference_sampler(name)(random.PRNGKey(9),
                                                                     1_000_000)))
        return x.mean(0), x.std(0) / x.shape[0] ** 0.5
    return torch.zeros(dim, dtype=torch.float64), torch.zeros(dim, dtype=torch.float64)


def occupancy(name, x):
    """(overall shares, min and max over chains of the first share) of the
    family's modes; x (draws, chains, dim)."""
    if name == "multimodal_funnel_2d":
        mode = (x[..., 0] > 0).double()[..., None]
    elif name.startswith("concentric"):
        u = x.abs().sum(-1, keepdim=True)
        mode = torch.nn.functional.one_hot(
            (u - torch.tensor([4.0, 8.0, 16.0], dtype=x.dtype)).abs().argmin(-1), 3).double()
    elif name.startswith("nested"):
        centres = torch.tensor([[0.0, 0.0], [2.0, 0.0], [-2.0, 0.0], [0.0, 2.0], [0.0, -2.0]],
                               dtype=x.dtype)
        radii = torch.tensor([20.0, 2.0, 2.0, 2.0, 2.0], dtype=x.dtype)
        dist = ((x[..., None, :] - centres).abs().sum(-1) - radii).abs()
        mode = torch.nn.functional.one_hot(dist.argmin(-1), 5).double()
    else:
        return None
    per_chain = mode.mean(dim=0)
    return (mode.mean(dim=(0, 1)).tolist(), float(per_chain[:, 0].min()),
            float(per_chain[:, 0].max()))


def grade(label, name, samples, ref, seconds):
    x = torch.from_numpy(np.array(samples)).double()
    n_draws, n_chains, dim = x.shape
    finite = bool(torch.isfinite(x).all())
    rhat = float(split_rhat(x).max())
    chain_means = x.mean(dim=0)
    mean = chain_means.mean(dim=0)
    line = f"{label}: {seconds:.1f} s, finite {finite}, R-hat {rhat:.4f}"
    if ref is not None:
        se_chains = chain_means.std(dim=0) / n_chains ** 0.5
        se_ess = x.std(dim=(0, 1)) / torch.sqrt(ess_bulk(x).double())
        z_chains = ((mean - ref[0]).abs() / (se_chains ** 2 + ref[1] ** 2).sqrt()).max()
        z_ess = ((mean - ref[0]).abs() / (se_ess ** 2 + ref[1] ** 2).sqrt()).max()
        far = float((chain_means - ref[0]).abs().max())
        line += (f", means' max z {float(z_chains):.3f} by the chains' spread, "
                 f"{float(z_ess):.3f} by bulk ESS; largest |chain mean - reference| {far:.4f}")
    occ = occupancy(name, x)
    if occ is not None:
        line += (f"; mode shares {[round(s, 4) for s in occ[0]]}, one chain's first-mode share "
                 f"{occ[1]:.4f}..{occ[2]:.4f}")
    print(line, flush=True)


def run_cell(cell, chains, draws, seed):
    name, dim, samplers, metric, schedule, L = CELLS[cell]
    t = get_target(name, dim=dim)
    ref = reference(name, dim)
    key = random.PRNGKey(seed)
    k_init, k_g, k_gs, k_r, k_rs, k_n, k_ns = random.split(key, 7)
    init = t.init_sampler(k_init, chains)
    for sampler in samplers:
        t0 = time.time()
        if sampler == "grahmc":
            step, inv_mass, pos, info = run_adaptive_warmup(
                "grahmc", t.log_prob_fn, None, init, k_g, num_warmup=2500, target_accept=0.65,
                schedule_type=schedule, learn_mass_matrix=metric,
                value_and_grad_fn=t.value_and_grad_fn, backend="xla", num_steps=L, gamma=1.0,
                steepness=default_steepness(schedule))
            res = grahmc_run(k_gs, t.log_prob_fn, pos, step, L, info["gamma"],
                             info["steepness"], draws, inv_mass_matrix=inv_mass,
                             friction_schedule=get_friction_schedule(schedule),
                             value_and_grad_fn=t.value_and_grad_fn)
            note = f" (step {step:.5f}, gamma {info['gamma']:.4f})"
        elif sampler == "rwmh":
            scale, _ = dual_averaging_tune_rwmh(k_r, t.log_prob_fn, init, max_iter=1000)
            res = rwmh_run(k_rs, t.log_prob_fn, init, draws, scale,
                           value_and_grad_fn=t.value_and_grad_fn)
            note = f" (scale {scale:.5f})"
        else:
            step, inv_mass, pos, _ = run_adaptive_warmup(
                "nuts", t.log_prob_fn, None, init, k_n, num_warmup=2500, target_accept=0.65,
                learn_mass_matrix=metric, value_and_grad_fn=t.value_and_grad_fn,
                backend="persistent", max_tree_depth=15, nuts_proposal="endpoint")
            res = nuts_run_persistent(k_ns, t.log_prob_fn, pos, step, draws, steps_per_sample=64,
                                      inv_mass_matrix=inv_mass, max_tree_depth=10,
                                      value_and_grad_fn=t.value_and_grad_fn)
            note = f" (step {step:.5f})"
        jax.block_until_ready(res.samples)
        grade(f"{cell} {sampler}{note}", name, res.samples, ref, time.time() - t0)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chains", type=int, default=64)
    parser.add_argument("--draws", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cells", nargs="+", default=list(CELLS), choices=list(CELLS))
    args = parser.parse_args()
    print(f"JAX {jax.__version__} on {jax.default_backend()}, {args.chains} chains x "
          f"{args.draws} draws, seed {args.seed}", flush=True)
    for cell in args.cells:
        run_cell(cell, args.chains, args.draws, args.seed)


if __name__ == "__main__":
    main()
