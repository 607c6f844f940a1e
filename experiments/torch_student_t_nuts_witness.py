"""Persistent NUTS on the 10-D Student-t(3): the JAX package's XLA machine,
the port's eager machine (kernel 4's plain version) and the port's kernel 4
side by side, against the exact distribution.

    JAX_PLATFORMS=cpu python experiments/torch_student_t_nuts_witness.py \
        --runs jax eager exact [--chains 64] [--draws 10000] [--slots 64]
    python experiments/torch_student_t_nuts_witness.py --runs fused exact \
        --device cuda --chains 1024 --slots 64 1024

Every run starts from exact draws (so it is stationary from its first
draw) at the same step and diagonal metric, one emitted draw per window of
`slots` leapfrog slots, uniform snapshots and the `--scheme` proposal
scheme (each package's default: endpoint). Each run prints, for the grand mean (truth 0), its
largest |.| and z with two MCSEs: the spread of the chains' means, and
sd / sqrt(bulk ESS); the largest |chain mean|; the share of draws with |x|
> 6 and > 15 against the exact shares; the longest stretch of consecutive
draws a chain coordinate spent beyond 15; the largest share of one chain's
draws beyond 15; and the transitions completed per draw. "jax" imports
the JAX package (CPU only); the other runs need only torch.
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu_torch.diagnostics import ess_bulk_chunked  # noqa: E402
from mcmc_tpu_torch.samplers import nuts_run_persistent as t_nuts  # noqa: E402
from mcmc_tpu_torch.targets import get_reference_sampler, get_target  # noqa: E402

DF = 3.0
CUTS = (6.0, 15.0)


def t3_tail(c):
    """P(|T| > c) for Student-t(3), in closed form."""
    u = c / math.sqrt(DF)
    return 1.0 - (2.0 / math.pi) * (u / (1.0 + u * u) + math.atan(u))


def longest_run(mask):
    """Longest stretch of consecutive True along axis 0 of a (N, ...) mask."""
    idx = torch.arange(mask.shape[0], device=mask.device).view(-1, *([1] * (mask.ndim - 1)))
    last_out = torch.cummax(torch.where(mask, -1, idx.expand_as(mask)), dim=0).values
    return int((idx - last_out).masked_fill(~mask, 0).max())


def report(label, samples, seconds, transitions=None):
    """samples: (draws, chains, dim)."""
    x = samples.double()
    n_draws, n_chains, _ = x.shape
    chain_means = x.mean(dim=0)
    mean = chain_means.mean(dim=0)
    sd = x.std(dim=(0, 1))
    ess = ess_bulk_chunked(samples.float(), chain_chunk=n_chains, dim_chunk=4).double()
    z_chain = float((mean.abs() / (chain_means.std(dim=0) / n_chains ** 0.5)).max())
    z_ess = float((mean.abs() / (sd / ess.sqrt())).max())
    shares = [float((x.abs() > c).double().mean()) for c in CUTS]
    far = x.abs() > CUTS[-1]
    chain_far = float(far.double().mean(dim=(0, 2)).max())
    per_draw = "" if transitions is None else (
        f", transitions per draw {float(transitions.double().mean()) / n_draws:.3f}")
    print(f"{label:34s} max |mean| {float(mean.abs().max()):.5f} (z {z_chain:.2f} chains' "
          f"spread, {z_ess:.2f} bulk ESS; min bulk ESS {float(ess.min()):.0f}); max |chain "
          f"mean| {float(chain_means.abs().max()):.4f}; "
          + ", ".join(f"P(|x| > {c:g}) {s:.6f} ({s / t3_tail(c):.3f} x exact)"
                      for c, s in zip(CUTS, shares))
          + f"; longest stretch beyond {CUTS[-1]:g} {longest_run(far)} draws, one chain's "
          f"share there {chain_far:.5f}{per_draw}; {seconds:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", default=["jax", "eager", "exact"],
                    choices=["jax", "eager", "fused", "exact"])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--draws", type=int, default=10000)
    ap.add_argument("--slots", type=int, nargs="+", default=[64])
    ap.add_argument("--scheme", default="endpoint", choices=["endpoint", "multinomial"])
    ap.add_argument("--step", type=float, default=0.9)
    ap.add_argument("--inv-mass", type=float, default=3.0,
                    help="the diagonal metric's entry, every coordinate")
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    init = get_reference_sampler("student_t", args.dim)(g, args.chains).float()
    invm = torch.full((args.dim,), args.inv_mass, device=dev)
    t = get_target("student_t", dim=args.dim)
    print(f"Student-t({DF:g}) D {args.dim}, {args.chains} chains x {args.draws} draws, step "
          f"{args.step}, inverse metric {args.inv_mass}, exact starts, the {args.scheme} "
          f"scheme; {args.device}", flush=True)
    if "exact" in args.runs:
        t0 = time.time()
        ex = get_reference_sampler("student_t", args.dim)(
            g, args.draws * args.chains).reshape(args.draws, args.chains, args.dim)
        report("exact i.i.d.", ex, time.time() - t0)
        del ex
    for slots in args.slots:
        kw = dict(num_samples=args.draws, steps_per_sample=slots, proposal_scheme=args.scheme)
        if "jax" in args.runs:
            import jax
            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as jnp
            from mcmc_tpu.samplers.nuts_persistent import nuts_run_persistent as j_nuts
            from mcmc_tpu.targets import get_target as j_get_target
            jt = j_get_target("student_t", dim=args.dim)
            t0 = time.time()
            r = j_nuts(jax.random.PRNGKey(args.seed + 1), jt.log_prob_fn,
                       jnp.asarray(init.cpu().numpy()), args.step,
                       inv_mass_matrix=jnp.asarray(invm.cpu().numpy()),
                       value_and_grad_fn=jt.value_and_grad_fn, backend="xla", **kw)
            s = torch.from_numpy(np.array(r.samples))
            report(f"jax xla, {slots} slots", s, time.time() - t0,
                   torch.from_numpy(np.array(r.info["transitions"]))
                   if "transitions" in r.info else None)
            del r, s
        for backend in ("eager", "fused"):
            if backend not in args.runs:
                continue
            t0 = time.time()
            r = t_nuts(torch.Generator(device=dev).manual_seed(args.seed + 1), t.log_prob_fn,
                       init, args.step, inv_mass_matrix=invm,
                       value_and_grad_fn=t.value_and_grad_fn, backend=backend, **kw)
            s = r.samples.cpu()
            report(f"port {backend}, {slots} slots", s, time.time() - t0,
                   r.info.get("transitions"))
            del r, s


if __name__ == "__main__":
    main()
