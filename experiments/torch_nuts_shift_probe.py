"""Persistent NUTS's shift of the hierarchical posterior's means, on the JAX
package and on its PyTorch port side by side (CPU).

    JAX_PLATFORMS=cpu python experiments/torch_nuts_shift_probe.py \
        [--dim 12] [--n-data 32] [--chains 256] [--slots 64 512] [--seeds 4]

The JAX package's windowed GRAHMC warmup tunes a step and a diagonal
metric; a long XLA HMC run at that step is the reference. Then, from the
same warmed states at the same step and metric, the JAX XLA persistent
NUTS machine and the port's eager one run each proposal scheme at each
window length (slots a draw, one emitted draw per window), and each run
prints tau's shift from the reference in posterior sd, its z (combined
MCSE, sd / sqrt(bulk ESS)) and the largest z over the coordinates. The
JAX machine's `snapshot_mode="last"` (deterministic-time emission, the
occupancy measure) is printed beside them for scale.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu.samplers import hmc_run  # noqa: E402
from mcmc_tpu.samplers.nuts_persistent import nuts_run_persistent as j_nuts  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu.tuning import run_adaptive_warmup  # noqa: E402
from mcmc_tpu_torch.diagnostics import ess_bulk  # noqa: E402
from mcmc_tpu_torch.samplers import nuts_run_persistent as t_nuts  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402


def mean_mcse_sd(samples):
    s = torch.from_numpy(np.array(samples, np.float64))
    sd = s.std(dim=(0, 1))
    return s.mean((0, 1)), sd / ess_bulk(s).sqrt(), sd


def report(label, run, ref, seconds):
    shift = (run[0] - ref[0]) / ref[2]
    z = (run[0] - ref[0]).abs() / (run[1] ** 2 + ref[1] ** 2).sqrt()
    print(f"{label:40s} tau shift {float(shift[0]):+.4f} sd (z {float(z[0]):6.2f}), "
          f"max z {float(z.max()):6.2f}, max |shift| {float(shift.abs().max()):.4f} sd, "
          f"{seconds:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=12)
    ap.add_argument("--n-data", type=int, default=32)
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--slots", type=int, nargs="+", default=[64, 512])
    ap.add_argument("--seeds", type=int, nargs="+", default=[4])
    ap.add_argument("--draw-slots", type=int, default=51200,
                    help="slots per chain of each NUTS run (draws = this / slots a draw)")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    jt = j_get_target("hierarchical_logistic", dim=args.dim, n_data=args.n_data)
    tt = t_get_target("hierarchical_logistic", dim=args.dim, n_data=args.n_data)
    rng = np.random.default_rng(9)
    init = rng.standard_normal((args.chains, args.dim)).astype(np.float32) * 0.3
    init[:, 0] = rng.standard_normal(args.chains) * 0.5
    step, m, pos, _ = run_adaptive_warmup(
        "grahmc", jt.log_prob_fn, None, jnp.asarray(init), random.PRNGKey(1),
        value_and_grad_fn=jt.value_and_grad_fn, backend="xla", num_warmup=300,
        schedule_type="tanh", num_steps=8, exploration_steps=100,
        adaptation_windows=[50, 100, 200], cooldown_steps=50, max_iter_step=60,
        gamma_samples_per_eval=20)
    step = float(step)
    t0 = time.time()
    ref = mean_mcse_sd(hmc_run(random.PRNGKey(2), jt.log_prob_fn, pos, step, 8, 2000,
                               inv_mass_matrix=m, value_and_grad_fn=jt.value_and_grad_fn).samples)
    print(f"D {args.dim}, n_data {args.n_data}, {args.chains} chains; step {step:.6f}; "
          f"reference: XLA HMC, 2000 draws, tau {float(ref[0][0]):+.5f} (sd "
          f"{float(ref[2][0]):.5f}, MCSE {float(ref[1][0]):.5f}), {time.time() - t0:.1f} s",
          flush=True)
    t_pos, t_m = torch.from_numpy(np.array(pos)), torch.from_numpy(np.array(m))
    for scheme in ("endpoint", "multinomial"):
        for slots in args.slots:
            kw = dict(num_samples=args.draw_slots // slots, steps_per_sample=slots,
                      proposal_scheme=scheme)
            for seed in args.seeds:
                for mode in ("uniform", "last"):
                    t0 = time.time()
                    r = j_nuts(random.PRNGKey(seed), jt.log_prob_fn, pos, step,
                               inv_mass_matrix=m, value_and_grad_fn=jt.value_and_grad_fn,
                               backend="xla", snapshot_mode=mode, **kw)
                    report(f"jax {scheme} {slots} slots {mode} seed {seed}",
                           mean_mcse_sd(r.samples), ref, time.time() - t0)
                t0 = time.time()
                r = t_nuts(torch.Generator().manual_seed(seed), tt.log_prob_fn, t_pos, step,
                           inv_mass_matrix=t_m, value_and_grad_fn=tt.value_and_grad_fn,
                           backend="eager", **kw)
                report(f"port {scheme} {slots} slots uniform seed {seed}",
                       mean_mcse_sd(r.samples), ref, time.time() - t0)


if __name__ == "__main__":
    main()
