#!/usr/bin/env python3
"""Drive the mcmc_tpu_torch main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and nvcc. It
builds the hand-written CUDA kernels from mcmc_tpu_torch/csrc, holds each
against its plain PyTorch version at its main-path shape, checks the
in-kernel Philox draws statistically (fused against eager), then runs the
three device rows of bench.py on the port:

- GRAHMC: the 50-D Neal's funnel at 65,536 chains, L = 16 and the constant
  schedule, the step size tuned by dual averaging through the fused kernel,
  a timed 768-draw run, a 192-draw full-history run with chunked bulk ESS,
  and a 4,096-chain run through the multi-transition kernel (kernels 1, 2);
- persistent NUTS: the same funnel at 65,536 chains, the step size tuned by
  dual averaging through the persistent path, then 192 draws of 64 slots,
  timed, with the last rep's full-history bulk ESS (kernel 4);
- RWMH: the 10-D standard normal at 65,536 chains, 16,384 draws, 32
  transitions per call (kernel 3).

Every phase passes or raises; there is no CPU path. The last two lines are a
JSON object describing each kernel and {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

DIM = 50
CHAINS = 65536
NUM_STEPS = 16
GAMMA = 1.0
STEEPNESS = 1.0
DA_INIT_STEP = 0.1
TARGET_ACCEPT = 0.65
TUNE_BATCHES = 40
TUNE_BATCH_LEN = 10
TIMED_SAMPLES = 768
COLLECT = 64
TIMED_REPS = 5
ESS_SAMPLES = 192
MULTI_CHAINS = 4096
MULTI_T = 8
MULTI_SAMPLES = 256
PARITY_STEP = 0.024          # near the tuned step of this configuration

# persistent-NUTS row (bench.py:279-291, 413-451)
NUTS_CHAINS = 65536
NUTS_STEPS_PER_SAMPLE = 64
NUTS_SAMPLES = 192
NUTS_W = 4                   # steps_per_iter the run picks for 64 and 96
NUTS_ITERS = NUTS_STEPS_PER_SAMPLE // NUTS_W
NUTS_DEPTH = 10
# bench.py tunes with 15 runs; there dual averaging still swings between
# steps 0.13 and 0.34 (the funnel's accept falls steeply with the step) and
# the smoothed step lands near 0.235 with accept ~0.79, on the JAX package as
# on the port (2,048 chains on a CPU); after 40 runs both settle at 0.27.
NUTS_TUNE_CALLS = 40
NUTS_TUNE_SPS = 96
NUTS_REPS = 4                # first rep dropped
NUTS_PARITY_STEP = 0.25      # near the JAX package's tuned 0.268 here
NUTS_STATS_CHAINS = 4096
NUTS_STATS_STEP = 0.3
# RWMH row (bench.py:495-525)
RWMH_DIM = 10
RWMH_CHAINS = 65536
RWMH_SAMPLES = 16384
RWMH_T = 32                  # transitions per call rwmh_run picks
RWMH_COLLECT = 64
RWMH_SCALE = 2.38 / RWMH_DIM ** 0.5
RWMH_REPS = 6                # first rep dropped (bench.py:_timed_reps)
SPLIT_MAX = 1e-3             # share of chains whose path may split
IN_FLIGHT_MAX = 0.05         # funnel: share whose trajectory in flight may drift

KERNELS = {   # name: (source, the TPU kernel it replaces)
    "grahmc_step_kernel": ("mcmc_tpu_torch/csrc/fused_trajectory.cu",
                           "mcmc_tpu/ops/fused_trajectory.py:280"),
    "grahmc_multistep_kernel": ("mcmc_tpu_torch/csrc/fused_trajectory.cu",
                                "mcmc_tpu/ops/fused_trajectory.py:683"),
    "rwmh_multistep_kernel": ("mcmc_tpu_torch/csrc/fused_rwmh.cu",
                              "mcmc_tpu/ops/fused_rwmh.py:44"),
    "nuts_window_kernel": ("mcmc_tpu_torch/csrc/fused_nuts.cu",
                           "mcmc_tpu/ops/fused_nuts.py:139"),
}


def say(msg=""):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# ---------------------------------------------------------------------------
# Phase 3: kernel against plain version
# ---------------------------------------------------------------------------

def _compare(label, torch, kern, plain, log_u, alive):
    """Compare one transition of kernel and plain version on the chains in
    `alive`. kern/plain: dicts with "accept" and "delta_h" (C,) and any of
    "q", "lp", "grad". Accepts must agree except where
    |log u - min(0, log alpha)| < 1e-4; q, lp and grad within rtol/atol 1e-4
    on agreeing chains, delta H within rtol/atol 2e-3 on agreeing chains that
    did not diverge (|dH| < 1000; a divergent trajectory's dH is chaotic).
    Returns (max abs error of q/lp/grad, chains whose accepts agree)."""
    acck, accp, dhp = kern["accept"], plain["accept"], plain["delta_h"]
    borderline = (log_u - torch.clamp(-dhp, max=0.0)).abs() < 1e-4
    differ = (acck != accp) & alive
    n_bad = int((differ & ~borderline).sum())
    require(n_bad == 0, f"{label}: {n_bad} accept decisions differ away from "
            f"the borderline")
    same = alive & (acck == accp)
    stable = same & (dhp.abs() < 1000.0)
    require(bool(((kern["delta_h"].abs() < 1000.0) == (dhp.abs() < 1000.0))[same].all()),
            f"{label}: divergence flags differ")
    err = 0.0
    for name in ("q", "lp", "grad", "delta_h"):
        if name not in kern:
            continue
        rows, tol = (stable, 2e-3) if name == "delta_h" else (same, 1e-4)
        a, b = kern[name][rows], plain[name][rows]
        bad = (a - b).abs() > tol + tol * b.abs()
        require(not bool(bad.any()), f"{label}: {name} differs beyond {tol}")
        if name != "delta_h" and a.numel():
            err = max(err, float((a - b).abs().max()))
    say(f"  {label}: accepts agree on {int(same.sum())}/{int(alive.sum())} "
        f"(borderline {int((differ & borderline).sum())}), divergent "
        f"{int((same & ~stable).sum())}, max |err| {err:.3g}")
    return err, same


def _fields(out, t=None):
    """Named fields of a kernel/plain result tuple, at transition t for
    the multistep layout."""
    if t is None:
        q, lp, grad, acc, dh, _, _ = out
        return {"q": q, "lp": lp, "grad": grad, "accept": acc, "delta_h": dh}
    _, _, _, acc, dh, hist_q, hist_lp = out
    return {"q": hist_q[t], "lp": hist_lp[t], "accept": acc[t], "delta_h": dh[t]}


def phase_parity(torch, ft, targets, dev):
    """Kernels against their plain versions, both on the card, on identical
    inputs: injected randoms, then the in-kernel Philox against the plain
    version's Philox with the same key and call index."""
    say("[3] kernel vs plain version on the card")
    funnel = targets.neals_funnel(DIM)
    normal = targets.standard_normal(DIM)
    g = torch.Generator(device=dev).manual_seed(100)
    key = ft.PhiloxStream.from_generator(g, dev).key
    ones = torch.ones(DIM, device=dev)
    max_err = {"grahmc_step_kernel": 0.0, "grahmc_multistep_kernel": 0.0}

    def state_for(t, n):
        q = torch.randn((n, DIM), generator=g, device=dev) * 0.5
        lp, grad = t.value_and_grad_fn(q)
        return q, lp.contiguous(), grad.contiguous()

    def uniforms(shape):
        return torch.rand(shape, generator=g, device=dev).clamp_min(2.0 ** -25)

    # kernel 1 at the main-path shape
    cases = [("funnel/constant injected", funnel, "constant", PARITY_STEP, GAMMA,
              STEEPNESS, True),
             ("normal/tanh injected", normal, "tanh", 0.15, 0.8, 2.0, True),
             ("funnel/constant philox", funnel, "constant", PARITY_STEP, GAMMA,
              STEEPNESS, False)]
    for label, t, sched, eps, gamma, steep, injected in cases:
        args = (t.value_and_grad_fn.kernel_info, NUM_STEPS, ft.SCHEDULE_IDS[sched],
                *state_for(t, CHAINS), ft.kernel_scalars(eps, gamma, steep, dev), ones)
        if injected:
            u = uniforms(CHAINS)
            rand = dict(p0=torch.randn((CHAINS, DIM), generator=g, device=dev), u=u)
        else:
            u = ft.philox_uniform(key, 7, 0, CHAINS, dev)
            rand = dict(key=key, call=7)
        kern = ft.grahmc_step_kernel(*args, **rand)
        plain = ft.grahmc_step_plain(*args, **rand)
        torch.cuda.synchronize()
        err, same = _compare(f"step {label}", torch, _fields(kern), _fields(plain),
                             torch.log(u), torch.ones(CHAINS, dtype=torch.bool, device=dev))
        max_err["grahmc_step_kernel"] = max(max_err["grahmc_step_kernel"], err)
        ok = same & (plain[4].abs() < 1000.0)
        require(torch.allclose(kern[5][ok], plain[5][ok], rtol=1e-4, atol=1e-4),
                f"step {label}: proposal q differs")

    # kernel 2 at its main-path shape
    info = funnel.value_and_grad_fn.kernel_info
    scalars = ft.kernel_scalars(PARITY_STEP, GAMMA, STEEPNESS, dev)
    state = state_for(funnel, MULTI_CHAINS)
    u = uniforms((MULTI_T, MULTI_CHAINS))
    p0 = torch.randn((MULTI_T, MULTI_CHAINS, DIM), generator=g, device=dev)
    for mode, rand, u_all in (
            ("injected", dict(p0=p0, u=u), u),
            ("philox", dict(key=key, call=3), torch.stack(
                [ft.philox_uniform(key, 3, t, MULTI_CHAINS, dev)
                 for t in range(MULTI_T)]))):
        args = (info, NUM_STEPS, ft.SCHEDULE_IDS["constant"], MULTI_T, *state,
                scalars, ones)
        kern = ft.grahmc_multistep_kernel(*args, **rand)
        plain = ft.grahmc_multistep_plain(*args, **rand)
        torch.cuda.synchronize()
        alive = torch.ones(MULTI_CHAINS, dtype=torch.bool, device=dev)
        for t in range(MULTI_T):
            # a chain leaves the comparison after its first borderline split
            err, alive = _compare(f"multistep {mode} t={t}", torch, _fields(kern, t),
                                  _fields(plain, t), torch.log(u_all[t]), alive)
            max_err["grahmc_multistep_kernel"] = max(
                max_err["grahmc_multistep_kernel"], err)
        require(torch.allclose(kern[2][alive], plain[2][alive], rtol=1e-4, atol=1e-4),
                f"multistep {mode}: final grad differs")
    return max_err


def _gen(torch, dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _close_on(pairs, tol=1e-4):
    """(max |a - b|, whether every |a - b| <= tol + tol |b|) over the
    (a, b) pairs, each already cut to the chains being compared."""
    err, within = 0.0, True
    for a, b in pairs:
        if a.numel():
            diff = (a - b).abs()
            err = max(err, float(diff.max()))
            within = within and bool((diff <= tol + tol * b.abs()).all())
    return err, within


def _split_check(label, agree, err, within, tol=1e-4):
    """An accept test at its margin may come out the other way under another
    summation order, after which the chain's path differs: at most SPLIT_MAX
    of the chains may split, and the rest must agree within tol."""
    n = agree.numel()
    n_split = n - int(agree.sum())
    say(f"  {label}: discrete state identical on {n - n_split}/{n} chains "
        f"({n_split} split), max |err| {err:.3g} on those")
    require(n_split <= SPLIT_MAX * n, f"{label}: {n_split} of {n} chains split")
    require(within, f"{label}: float state differs beyond {tol}")


def phase_parity_rwmh(torch, ft, fr, targets, dev):
    """Kernel 3 against its plain version at the RWMH row's shape (65,536 x
    10, T = 32, a 64-chain history): injected draws, then Philox."""
    say("[3b] kernel 3 (RWMH) vs plain version on the card")
    t = targets.standard_normal(RWMH_DIM)
    info = t.value_and_grad_fn.kernel_info
    g = _gen(torch, dev, 101)
    q = torch.randn((RWMH_CHAINS, RWMH_DIM), generator=g, device=dev) * 0.3
    lp = t.log_prob_fn(q).contiguous()
    scale = fr.rwmh_scale(RWMH_SCALE, dev)
    key = ft.PhiloxStream.from_generator(g, dev).key
    noise = torch.randn((RWMH_T, RWMH_CHAINS, RWMH_DIM), generator=g, device=dev)
    u = torch.rand((RWMH_T, RWMH_CHAINS), generator=g, device=dev).clamp_min(2.0 ** -25)
    max_err = 0.0
    for mode, rand in (("injected", dict(noise=noise, u=u)),
                       ("philox", dict(key=key, call=5))):
        args = (info, RWMH_T, q, lp, scale, RWMH_COLLECT)
        kern = fr.rwmh_multistep_kernel(*args, **rand)
        plain = fr.rwmh_multistep_plain(*args, **rand)
        torch.cuda.synchronize()
        agree = (kern[2] == plain[2]).all(dim=0)           # the accept sequence
        hist = agree[:RWMH_COLLECT]
        err, within = _close_on([(kern[0][agree], plain[0][agree]),
                                 (kern[1][agree], plain[1][agree]),
                                 (kern[3][:, hist], plain[3][:, hist]),
                                 (kern[4][:, hist], plain[4][:, hist])])
        _split_check(f"rwmh {mode}", agree, err, within)
        require(0.1 < float(kern[2].float().mean()) < 0.5, f"rwmh {mode}: accept")
        max_err = max(max_err, err)
    return {"rwmh_multistep_kernel": max_err}


def _clone_state(ps):
    return type(ps)(*(t.clone() for t in ps))


def phase_parity_nuts(torch, ft, fn, tn, targets, dev):
    """Kernel 4 against its plain version at the NUTS row's shape (65,536 x
    50, 16 iterations x W = 4, depth 10) from a state in mid-flight:
    injected draws, then Philox. On the standard normal every chain that
    does not split must agree in every field. On the funnel, the main path's
    target, the leapfrog is unstable in the neck at this step (exp(x0 / 2)
    below the step), so there a rounding difference grows within a subtree
    until the subtree ends divergent: the trajectory in flight may differ on
    up to IN_FLIGHT_MAX of the chains, while the emitted state is held to the
    SPLIT_MAX rule."""
    say("[3c] kernel 4 (persistent NUTS window) vs plain version on the card")
    max_err = 0.0
    for family, in_flight_max in (("standard_normal", SPLIT_MAX),
                                  ("neals_funnel", IN_FLIGHT_MAX)):
        t = getattr(targets, family)(DIM)
        info = t.value_and_grad_fn.kernel_info
        g = _gen(torch, dev, 102)
        q = torch.randn((NUTS_CHAINS, DIM), generator=g, device=dev) * 0.5
        lp, grad = t.value_and_grad_fn(q)
        scalars = fn.nuts_scalars(NUTS_PARITY_STEP, 1000.0, dev)
        ones = torch.ones(DIM, device=dev)
        key = ft.PhiloxStream.from_generator(g, dev).key
        args = (info, NUTS_ITERS, NUTS_W, NUTS_DEPTH)
        warm = fn.nuts_window_kernel(*args, tn._init_pstate(q, lp, grad, torch.float32),
                                     scalars, ones, key=key, call=0)
        shape = (NUTS_ITERS, NUTS_CHAINS)
        draws = (torch.randn(shape + (DIM,), generator=g, device=dev),
                 torch.rand(shape, generator=g, device=dev) < 0.5,
                 torch.rand(shape, generator=g, device=dev) < 0.5,
                 torch.rand(shape, generator=g, device=dev),
                 torch.rand(shape, generator=g, device=dev).clamp_min(2.0 ** -25),
                 torch.rand(shape, generator=g, device=dev))
        for mode, rand in (("injected", dict(draws=draws)),
                           ("philox", dict(key=key, call=1))):
            kern = fn.nuts_window_kernel(*args, _clone_state(warm), scalars, ones, **rand)
            plain = fn.nuts_window_plain(*args, _clone_state(warm), scalars, ones, **rand)
            torch.cuda.synchronize()
            same, emitted, in_flight, err = fn.window_agreement(kern, plain)
            n = NUTS_CHAINS
            kept = same & emitted
            split = n - int(kept.sum())
            drift = int((kept & ~in_flight).sum())
            done = int((kern.transitions - warm.transitions).sum())
            executed = int((kern.n_exec - warm.n_exec).sum())
            say(f"  nuts {family} {mode}: discrete state identical on "
                f"{int(same.sum())}/{n} chains, emitted state within 1e-4 on "
                f"{n - split} ({split} split), trajectory in flight on "
                f"{n - split - drift} ({drift} drifted); max |err| {err:.3g}; "
                f"{done} transitions, {executed} of "
                f"{n * NUTS_STEPS_PER_SAMPLE} slots executed")
            require(split <= SPLIT_MAX * n, f"nuts {family} {mode}: {split} chains split")
            require(drift <= in_flight_max * n,
                    f"nuts {family} {mode}: {drift} trajectories in flight differ")
            require(done > 0, f"nuts {family} {mode}: no transition completed")
            max_err = max(max_err, err)
    return {"nuts_window_kernel": max_err}

# ---------------------------------------------------------------------------
# Phase 4: in-kernel Philox, statistically
# ---------------------------------------------------------------------------

def phase_philox_stats(torch, targets, samplers, dev):
    say("[4] in-kernel Philox: exact N(0, I_50) starts stay N(0, I_50)")
    t = targets.standard_normal(DIM)
    q0 = torch.randn((CHAINS, DIM), generator=torch.Generator(device=dev).manual_seed(20),
                     device=dev)
    tanh = samplers.get_friction_schedule("tanh")
    # eps 0.5 is the JAX package's 3-D invariance setting; in 50-D it accepts
    # ~3%, so eps 0.1 (accept ~0.6) is run as well for the accept > 0.5 check
    for eps, min_accept in ((0.5, None), (0.1, 0.5)):
        acc = {}
        for backend in ("fused", "eager"):
            res = samplers.grahmc_run(
                torch.Generator(device=dev).manual_seed(21), t.log_prob_fn, q0,
                step_size=eps, num_steps=8, gamma=0.5, steepness=5.0,
                num_samples=60, collect_chains=1, friction_schedule=tanh,
                value_and_grad_fn=t.value_and_grad_fn, backend=backend)
            var = res.final_state.position.var(dim=0)
            acc[backend] = float(res.accept_rate.mean())
            dev_max = float((var - 1.0).abs().max())
            say(f"  eps {eps} {backend}: accept {acc[backend]:.4f}, "
                f"max |var - 1| {dev_max:.4f}")
            require(dev_max < 0.03, f"{backend} eps {eps}: variance off 1 by {dev_max}")
        require(abs(acc["fused"] - acc["eager"]) < 0.02,
                f"eps {eps}: fused accept {acc['fused']} vs eager {acc['eager']}")
        if min_accept is not None:
            require(acc["fused"] > min_accept, f"eps {eps}: accept {acc['fused']}")


def phase_stats_rwmh_nuts(torch, targets, samplers, dev):
    """Fused against eager from exact N(0, I) starts: the in-kernel Philox
    draws must leave the target invariant as the eager torch.Generator
    draws do, with the same accept (and, for NUTS, tree depth)."""
    say("[4b] in-kernel Philox, RWMH 10-D and NUTS 50-D: fused against eager")
    t = targets.standard_normal(RWMH_DIM)
    q0 = torch.randn((RWMH_CHAINS, RWMH_DIM), generator=_gen(torch, dev, 22), device=dev)
    acc = {}
    for backend in ("fused", "eager"):
        res = samplers.rwmh_run(_gen(torch, dev, 23), t.log_prob_fn, q0, num_samples=64,
                                scale=RWMH_SCALE, collect_chains=1,
                                value_and_grad_fn=t.value_and_grad_fn, backend=backend)
        fin = res.final_state.position
        m, v = float(fin.mean(0).abs().max()), float((fin.var(0) - 1.0).abs().max())
        acc[backend] = float(res.accept_rate.mean())
        say(f"  rwmh {backend}: accept {acc[backend]:.4f}, max |mean| {m:.4f}, "
            f"max |var - 1| {v:.4f}")
        require(m < 0.03 and v < 0.03, f"rwmh {backend}: moments off N(0, I)")
    require(abs(acc["fused"] - acc["eager"]) < 0.01,
            f"rwmh accept: fused {acc['fused']} vs eager {acc['eager']}")

    t = targets.standard_normal(DIM)
    q0 = torch.randn((NUTS_STATS_CHAINS, DIM), generator=_gen(torch, dev, 24), device=dev)
    stats = {}
    for backend in ("fused", "eager"):
        res = samplers.nuts_run_persistent(
            _gen(torch, dev, 25), t.log_prob_fn, q0, step_size=NUTS_STATS_STEP,
            num_samples=16, steps_per_sample=NUTS_STEPS_PER_SAMPLE,
            value_and_grad_fn=t.value_and_grad_fn, backend=backend)
        flat = res.samples.reshape(-1, DIM)
        m = float(flat.mean(0).abs().max())
        v = float(flat.var(0).mean())
        stats[backend] = (v, float(torch.nanmean(res.info["mean_accept_probs"])),
                          float(res.info["mean_tree_depth"].mean()))
        say(f"  nuts {backend}: accept {stats[backend][1]:.4f}, mean tree depth "
            f"{stats[backend][2]:.3f}, max |mean| {m:.4f}, mean var {v:.4f}")
        # the endpoint scheme is a few percent underdispersed on both backends
        require(m < 0.05 and abs(v - 1.0) < 0.08, f"nuts {backend}: moments off N(0, I)")
    (vf, af, df), (ve, ae, de) = stats["fused"], stats["eager"]
    require(abs(vf - ve) < 0.02, f"nuts mean var: fused {vf} vs eager {ve}")
    require(abs(af - ae) < 0.02, f"nuts accept: fused {af} vs eager {ae}")
    require(abs(df - de) < 0.1, f"nuts tree depth: fused {df} vs eager {de}")


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------

def phase_main_path(torch, ft, targets, samplers, tuning, diagnostics, dev):
    say("[5] main path: 50-D funnel, 65,536 chains, L = 16, constant schedule")
    from mcmc_tpu_torch.samplers.base import init_chain_state
    t = targets.neals_funnel(DIM)
    constant = samplers.constant_schedule
    ones = torch.ones(DIM, device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def init(seed):
        return torch.randn((CHAINS, DIM), generator=gen(seed), device=dev) * 0.5

    # dual-averaging tune through kernel 1: no host read inside the loop
    t0 = time.perf_counter()
    state = init_chain_state(init(11), t.log_prob_fn, t.value_and_grad_fn)
    fused = ft.make_fused_grahmc_step(t.value_and_grad_fn, NUM_STEPS, constant)
    stream = ft.PhiloxStream.from_generator(gen(12), dev)
    da = tuning.da_init(DA_INIT_STEP, device=dev)
    for _ in range(TUNE_BATCHES):
        eps = tuning.da_step_size(da)
        accs = []
        for _ in range(TUNE_BATCH_LEN):
            state, (acc, *_rest) = fused(stream, state, eps, GAMMA, STEEPNESS, ones)
            accs.append(acc)
        da = tuning.da_update(da, torch.stack(accs).float().mean(), TARGET_ACCEPT)
    step = float(tuning.da_final_step_size(da))
    say(f"  tuned step {step:.6f} ({TUNE_BATCHES}x{TUNE_BATCH_LEN} transitions, "
        f"{time.perf_counter() - t0:.2f} s)")
    require(0.0 < step < 1.0, "tuned step out of range")

    kw = dict(step_size=step, num_steps=NUM_STEPS, gamma=GAMMA, steepness=STEEPNESS,
              burn_in=0, friction_schedule=constant,
              value_and_grad_fn=t.value_and_grad_fn, collect_chains=COLLECT,
              backend="fused")
    q_init = init(0)
    res = samplers.grahmc_run(gen(1), t.log_prob_fn, q_init,
                              num_samples=TIMED_SAMPLES, **kw)   # warm-up
    torch.cuda.synchronize()
    dts = []
    for rep in range(TIMED_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = samplers.grahmc_run(gen(2 + rep), t.log_prob_fn, q_init,
                                  num_samples=TIMED_SAMPLES, **kw)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    dt = statistics.median(dts)
    accept = float(res.accept_rate.mean())
    rate = CHAINS * TIMED_SAMPLES / dt
    say(f"  timed run: {TIMED_SAMPLES} draws x {CHAINS} chains, median of "
        f"{TIMED_REPS} reps {dt:.4f} s (reps {[round(x, 4) for x in dts]})")
    say(f"  accept {accept:.4f}; chain-steps/s {rate:.1f}")
    require(res.samples.shape == (TIMED_SAMPLES, COLLECT, DIM), "history shape")
    require(bool(torch.isfinite(res.samples).all()), "non-finite draws")
    require(bool(torch.isfinite(res.log_probs).all()), "non-finite log-probs")
    require(abs(accept - TARGET_ACCEPT) < 0.07, f"tuned accept {accept}")

    # full-history run (warm + timed) and chunked bulk ESS over all chains
    del res
    kw_full = dict(kw, collect_chains=None)
    res_full = samplers.grahmc_run(gen(9), t.log_prob_fn, q_init,
                                   num_samples=ESS_SAMPLES, **kw_full)
    del res_full
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_full = samplers.grahmc_run(gen(10), t.log_prob_fn, q_init,
                                   num_samples=ESS_SAMPLES, **kw_full)
    torch.cuda.synchronize()
    dt_full = time.perf_counter() - t0
    require(res_full.samples.shape == (ESS_SAMPLES, CHAINS, DIM), "full history shape")
    require(bool(torch.isfinite(res_full.samples).all()), "non-finite full history")
    t0 = time.perf_counter()
    ess = diagnostics.ess_bulk_chunked(res_full.samples, chain_chunk=8192, dim_chunk=4)
    rhat = diagnostics.split_rhat_chunked(res_full.samples, chain_chunk=8192, dim_chunk=4)
    torch.cuda.synchronize()
    ess_min = float(ess.min())
    require(bool(torch.isfinite(ess).all()) and ess_min > 0, "bulk ESS")
    say(f"  full-history run: {ESS_SAMPLES} draws x {CHAINS} chains in "
        f"{dt_full:.4f} s; min bulk-ESS {ess_min:.1f}, median "
        f"{float(ess.median()):.1f}, ESS/s {ess_min / dt_full:.1f}; max split "
        f"R-hat {float(rhat.max()):.4f} (diagnostics {time.perf_counter() - t0:.2f} s)")
    del res_full

    # <= 4096 chains: grahmc_run takes the multi-transition kernel
    q_small = q_init[:MULTI_CHAINS].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_m = samplers.grahmc_run(gen(30), t.log_prob_fn, q_small,
                                num_samples=MULTI_SAMPLES, **dict(kw, collect_chains=None))
    torch.cuda.synchronize()
    dt_m = time.perf_counter() - t0
    acc_m = float(res_m.accept_rate.mean())
    require(res_m.samples.shape == (MULTI_SAMPLES, MULTI_CHAINS, DIM), "multistep shape")
    require(bool(torch.isfinite(res_m.samples).all()), "non-finite multistep draws")
    require(abs(acc_m - TARGET_ACCEPT) < 0.1, f"multistep accept {acc_m}")
    say(f"  multistep run: {MULTI_SAMPLES} draws x {MULTI_CHAINS} chains in "
        f"{dt_m:.4f} s, accept {acc_m:.4f}, chain-steps/s "
        f"{MULTI_CHAINS * MULTI_SAMPLES / dt_m:.1f}")
    return step


def phase_nuts_row(torch, targets, samplers, tuning, diagnostics, dev):
    """bench.py's NUTS row on the port: DA tune through the persistent path
    (NUTS_TUNE_CALLS one-window runs, no host read inside), then 192 draws of
    64 slots at 65,536 chains, a warm-up and NUTS_REPS timed reps (first
    dropped), the median per-rep useful grads/s and the last rep's
    full-history ESS."""
    say("[5b] NUTS row: 50-D funnel, 65,536 chains, persistent NUTS (kernel 4)")
    t = targets.neals_funnel(DIM)
    t0 = time.perf_counter()
    pos = torch.randn((NUTS_CHAINS, DIM), generator=_gen(torch, dev, 11), device=dev) * 0.5
    da = tuning.da_init(DA_INIT_STEP, device=dev)
    for i in range(NUTS_TUNE_CALLS):
        res = samplers.nuts_run_persistent(
            _gen(torch, dev, 12 + i), t.log_prob_fn, pos,
            step_size=tuning.da_step_size(da), num_samples=1,
            steps_per_sample=NUTS_TUNE_SPS, value_and_grad_fn=t.value_and_grad_fn,
            collect_chains=8)
        pos = res.final_state.position
        da = tuning.da_update(da, torch.nanmean(res.info["mean_accept_probs"]),
                              TARGET_ACCEPT)
    step_t = tuning.da_final_step_size(da)
    step = float(step_t)
    say(f"  tuned step {step:.6f} ({NUTS_TUNE_CALLS} runs of {NUTS_TUNE_SPS} slots, "
        f"{time.perf_counter() - t0:.2f} s)")
    require(0.0 < step < 1.0, "tuned NUTS step out of range")

    n_init = torch.randn((NUTS_CHAINS, DIM), generator=_gen(torch, dev, 3), device=dev) * 0.5
    kw = dict(step_size=step_t, num_samples=NUTS_SAMPLES,
              steps_per_sample=NUTS_STEPS_PER_SAMPLE, value_and_grad_fn=t.value_and_grad_fn)
    res = samplers.nuts_run_persistent(_gen(torch, dev, 4), t.log_prob_fn, n_init, **kw)
    del res
    torch.cuda.synchronize()
    reps = []
    for rep in range(NUTS_REPS):
        t0 = time.perf_counter()
        res = samplers.nuts_run_persistent(_gen(torch, dev, 5 + rep), t.log_prob_fn,
                                           n_init, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        reps.append((int(res.info["n_leapfrogs"]), dt))
        if rep < NUTS_REPS - 1:
            del res
    rates = sorted(n / d for n, d in reps[1:])
    rate = rates[len(rates) // 2]
    slots = NUTS_SAMPLES * NUTS_STEPS_PER_SAMPLE * NUTS_CHAINS
    accept = float(torch.nanmean(res.info["mean_accept_probs"]))
    depth = float(res.info["mean_tree_depth"].mean())
    say(f"  timed runs: {NUTS_SAMPLES} draws x {NUTS_STEPS_PER_SAMPLE} slots x "
        f"{NUTS_CHAINS} chains; reps (leapfrogs, s) {[(n, round(d, 4)) for n, d in reps]}")
    say(f"  useful grads/s {rate:.1f} (median of reps 2-{NUTS_REPS}); executed "
        f"{reps[-1][0] / slots:.4f} of the slots; accept {accept:.4f}; mean tree depth "
        f"{depth:.3f}; divergences {int(res.info['total_divergences'])}")
    require(res.samples.shape == (NUTS_SAMPLES, NUTS_CHAINS, DIM), "NUTS history shape")
    require(bool(torch.isfinite(res.samples).all()), "non-finite NUTS draws")
    require(bool(torch.isfinite(res.log_probs).all()), "non-finite NUTS log-probs")
    require(abs(accept - TARGET_ACCEPT) < 0.1, f"tuned NUTS accept {accept}")
    require(int(res.info["n_leapfrogs"]) <= int(res.info["n_leapfrog_slots"]) == slots,
            "NUTS leapfrog counters")
    t0 = time.perf_counter()
    ess = diagnostics.ess_bulk_chunked(res.samples, chain_chunk=8192, dim_chunk=4)
    torch.cuda.synchronize()
    ess_min = float(ess.min())
    require(bool(torch.isfinite(ess).all()) and ess_min > 0, "NUTS bulk ESS")
    say(f"  last rep's full history: min bulk-ESS {ess_min:.1f}, median "
        f"{float(ess.median()):.1f}, ESS/s {ess_min / reps[-1][1]:.1f} "
        f"(diagnostics {time.perf_counter() - t0:.2f} s)")
    return step


def phase_rwmh_row(torch, targets, samplers, dev):
    """bench.py's RWMH row on the port: 65,536 chains of the 10-D standard
    normal, 16,384 draws through kernel 3 (T = 32), a warm-up and RWMH_REPS
    timed reps, the median of reps 2 and up."""
    say("[5c] RWMH row: 10-D standard normal, 65,536 chains (kernel 3)")
    t = targets.standard_normal(RWMH_DIM)
    r_init = torch.randn((RWMH_CHAINS, RWMH_DIM), generator=_gen(torch, dev, 6),
                         device=dev) * 0.3
    kw = dict(num_samples=RWMH_SAMPLES, scale=RWMH_SCALE, burn_in=0,
              collect_chains=RWMH_COLLECT, value_and_grad_fn=t.value_and_grad_fn,
              backend="fused")
    res = samplers.rwmh_run(_gen(torch, dev, 7), t.log_prob_fn, r_init, **kw)
    torch.cuda.synchronize()
    dts = []
    for rep in range(RWMH_REPS):
        t0 = time.perf_counter()
        res = samplers.rwmh_run(_gen(torch, dev, 8 + rep), t.log_prob_fn, r_init, **kw)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    tail = sorted(dts[1:])
    dt = tail[len(tail) // 2]
    accept = float(res.accept_rate.mean())
    say(f"  timed runs: {RWMH_SAMPLES} draws x {RWMH_CHAINS} chains, reps "
        f"{[round(x, 4) for x in dts]} s; chain-steps/s "
        f"{RWMH_CHAINS * RWMH_SAMPLES / dt:.1f}; accept {accept:.4f}")
    require(res.samples.shape == (RWMH_SAMPLES, RWMH_COLLECT, RWMH_DIM), "RWMH history shape")
    require(bool(torch.isfinite(res.samples).all()), "non-finite RWMH draws")
    require(0.2 < accept < 0.35, f"RWMH accept {accept}")


# ---------------------------------------------------------------------------
# Phase 6: kernel and plain times at the main-path shapes
# ---------------------------------------------------------------------------

def _event_ms(torch, fn, burst):
    """Device time per call of `burst` back-to-back calls between two CUDA
    events; a burst keeps the device busy, so the host's Python time per call
    (~60 us) does not enter a kernel's time unless it exceeds it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(burst):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / burst


def _interleaved(torch, fns, reps, bursts):
    """Per-call times (ms) of `reps` bursts of each of fns["kernel"] and
    fns["plain"], after a warm-up, taken in turns (plain, kernel, kernel,
    plain, ...)."""
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    ms = {"kernel": [], "plain": []}
    for rep in range(reps):
        order = ("plain", "kernel") if rep % 2 == 0 else ("kernel", "plain")
        for which in order:
            ms[which].append(_event_ms(torch, fns[which], bursts[which]))
    return ms


def phase_timing(torch, ft, targets, step, dev, reps=20, burst=10):
    """Median over `reps` samples of the time per call of kernel and plain
    version at the main-path shape, Philox mode as on the main path, samples
    interleaved in turns (plain, kernel, kernel, plain, ...)."""
    say(f"[6] kernel vs plain version: CUDA events, median of {reps} bursts of "
        f"{burst} calls, Philox mode")
    t = targets.neals_funnel(DIM)
    info = t.value_and_grad_fn.kernel_info
    g = torch.Generator(device=dev).manual_seed(40)
    key = ft.PhiloxStream.from_generator(g, dev).key
    scalars = ft.kernel_scalars(step, GAMMA, STEEPNESS, dev)
    ones = torch.ones(DIM, device=dev)
    sid = ft.SCHEDULE_IDS["constant"]
    times = {}
    for name, n, kernel_fn, plain_fn, lead in (
            ("grahmc_step_kernel", CHAINS, ft.grahmc_step_kernel,
             ft.grahmc_step_plain, ()),
            ("grahmc_multistep_kernel", MULTI_CHAINS, ft.grahmc_multistep_kernel,
             ft.grahmc_multistep_plain, (MULTI_T,))):
        q = torch.randn((n, DIM), generator=g, device=dev) * 0.5
        lp, grad = t.value_and_grad_fn(q)
        args = (info, NUM_STEPS, sid, *lead, q, lp.contiguous(), grad.contiguous(),
                scalars, ones)
        fns = {"kernel": lambda: kernel_fn(*args, key=key, call=0),
               "plain": lambda: plain_fn(*args, key=key, call=0)}
        ms = _interleaved(torch, fns, reps, {"kernel": burst, "plain": burst})
        times[name] = (statistics.median(ms["kernel"]), statistics.median(ms["plain"]))
        say(f"  {name} ({n} chains{', T = %d' % MULTI_T if lead else ''}, L = "
            f"{NUM_STEPS}): kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms; kernel quartiles "
            f"{[round(x, 4) for x in statistics.quantiles(ms['kernel'], n=4)]}")
    return times


def phase_timing_rwmh_nuts(torch, ft, fr, fn, tn, targets, nuts_step, dev, reps=10,
                           burst=10, plain_burst=1):
    """Kernels 3 and 4 against their plain versions at the rows' shapes,
    Philox mode: median over `reps` samples, `burst` kernel calls or
    `plain_burst` plain calls per sample. The NUTS window runs on from a
    state that two windows have already advanced, as in a run."""
    say(f"[6b] kernels 3 and 4 vs plain versions: CUDA events, median of {reps} "
        f"bursts of {burst} kernel / {plain_burst} plain calls, Philox mode")
    g = _gen(torch, dev, 41)
    key = ft.PhiloxStream.from_generator(g, dev).key
    times = {}

    t = targets.standard_normal(RWMH_DIM)
    q = torch.randn((RWMH_CHAINS, RWMH_DIM), generator=g, device=dev) * 0.3
    args = (t.value_and_grad_fn.kernel_info, RWMH_T, q, t.log_prob_fn(q).contiguous(),
            fr.rwmh_scale(RWMH_SCALE, dev), RWMH_COLLECT)
    fns = {"kernel": lambda: fr.rwmh_multistep_kernel(*args, key=key, call=0),
           "plain": lambda: fr.rwmh_multistep_plain(*args, key=key, call=0)}
    ms = _interleaved(torch, fns, reps, {"kernel": burst, "plain": plain_burst})
    times["rwmh_multistep_kernel"] = (statistics.median(ms["kernel"]),
                                      statistics.median(ms["plain"]))

    t = targets.neals_funnel(DIM)
    info = t.value_and_grad_fn.kernel_info
    q = torch.randn((NUTS_CHAINS, DIM), generator=g, device=dev) * 0.5
    lp, grad = t.value_and_grad_fn(q)
    scalars = fn.nuts_scalars(nuts_step, 1000.0, dev)
    ones = torch.ones(DIM, device=dev)
    args = (info, NUTS_ITERS, NUTS_W, NUTS_DEPTH)
    state = tn._init_pstate(q, lp, grad, torch.float32)
    for call in range(2):
        state = fn.nuts_window_kernel(*args, state, scalars, ones, key=key, call=call)
    states = {"kernel": state, "plain": _clone_state(state)}
    fns = {"kernel": lambda: fn.nuts_window_kernel(*args, states["kernel"], scalars, ones,
                                                   key=key, call=2),
           "plain": lambda: fn.nuts_window_plain(*args, states["plain"], scalars, ones,
                                                 key=key, call=2)}
    ms = _interleaved(torch, fns, reps, {"kernel": burst, "plain": plain_burst})
    times["nuts_window_kernel"] = (statistics.median(ms["kernel"]),
                                   statistics.median(ms["plain"]))
    for name, shape in (("rwmh_multistep_kernel",
                         f"{RWMH_CHAINS} x {RWMH_DIM}, T = {RWMH_T}"),
                        ("nuts_window_kernel",
                         f"{NUTS_CHAINS} x {DIM}, {NUTS_ITERS} iterations x W = "
                         f"{NUTS_W}, step {nuts_step:.4f}")):
        say(f"  {name} ({shape}): kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms")
    return times


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mcmc_tpu_torch import diagnostics, samplers, targets, tuning
    from mcmc_tpu_torch.ops import _cuda
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.ops import fused_rwmh as fr
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.samplers import nuts_persistent as tn

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    say("[1] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    say(smi[0])
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    say("[2] build kernels from mcmc_tpu_torch/csrc")
    lib = _cuda.load_library()
    say(f"  {lib.path.name}: built in {lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            say(f"  ptxas: {line.strip()}")

    max_err = phase_parity(torch, ft, targets, dev)
    max_err.update(phase_parity_rwmh(torch, ft, fr, targets, dev))
    max_err.update(phase_parity_nuts(torch, ft, fn, tn, targets, dev))
    phase_philox_stats(torch, targets, samplers, dev)
    phase_stats_rwmh_nuts(torch, targets, samplers, dev)

    kernels = {"grahmc_step_kernel": ft.grahmc_step_kernel,
               "grahmc_multistep_kernel": ft.grahmc_multistep_kernel,
               "rwmh_multistep_kernel": fr.rwmh_multistep_kernel,
               "nuts_window_kernel": fn.nuts_window_kernel}
    launches = {}

    def drive(label, run, expected):
        """Run one main path with every count set to 0 just before it; each
        kernel must launch exactly as often as `expected` says (0 for the
        kernels of the other paths)."""
        for k in kernels.values():
            k.launches = 0
        out = run()
        got = {name: k.launches for name, k in kernels.items()}
        want = {name: expected.get(name, 0) for name in kernels}
        say(f"  launches on the {label}: {got} (expected {want})")
        require(got == want, f"{label}: launches {got}, expected {want}")
        launches.update({name: got[name] for name in expected})
        return out

    g_step = drive("GRAHMC main path",
                   lambda: phase_main_path(torch, ft, targets, samplers, tuning,
                                           diagnostics, dev),
                   {"grahmc_step_kernel": TUNE_BATCHES * TUNE_BATCH_LEN
                    + TIMED_SAMPLES * (1 + TIMED_REPS) + 2 * ESS_SAMPLES,
                    "grahmc_multistep_kernel": MULTI_SAMPLES // MULTI_T})
    n_step = drive("NUTS row",
                   lambda: phase_nuts_row(torch, targets, samplers, tuning, diagnostics,
                                          dev),
                   {"nuts_window_kernel": NUTS_TUNE_CALLS
                    + NUTS_SAMPLES * (1 + NUTS_REPS)})
    drive("RWMH row", lambda: phase_rwmh_row(torch, targets, samplers, dev),
          {"rwmh_multistep_kernel": RWMH_SAMPLES // RWMH_T * (1 + RWMH_REPS)})
    require(all(n > 0 for n in launches.values()) and set(launches) == set(kernels),
            f"a kernel no main path launched: {launches}")

    times = phase_timing(torch, ft, targets, g_step, dev)
    times.update(phase_timing_rwmh_nuts(torch, ft, fr, fn, tn, targets, n_step, dev))
    say(f"[7] done in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name][0], "plain_ms": times[name][1]}
        for name in kernels]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
