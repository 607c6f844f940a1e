#!/usr/bin/env python3
"""Drive the mcmc_tpu_torch GRAHMC main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and nvcc. It
builds the hand-written CUDA kernels from mcmc_tpu_torch/csrc, holds each
against its plain PyTorch version, checks the in-kernel Philox draws
statistically, then runs the main path of bench.py on the port: the 50-D
Neal's funnel at 65,536 chains, GRAHMC with L = 16 and the constant
schedule, the step size tuned by dual averaging through the fused kernel,
a timed 768-draw run, a 192-draw full-history run with chunked bulk ESS,
and a 4,096-chain run through the multi-transition kernel.

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

REPLACES = {
    "grahmc_step_kernel": "mcmc_tpu/ops/fused_trajectory.py:280",
    "grahmc_multistep_kernel": "mcmc_tpu/ops/fused_trajectory.py:683",
}
SOURCE = "mcmc_tpu_torch/csrc/fused_trajectory.cu"


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
        for f in fns.values():   # warm-up
            f()
        torch.cuda.synchronize()
        ms = {"kernel": [], "plain": []}
        for rep in range(reps):
            order = ("plain", "kernel") if rep % 2 == 0 else ("kernel", "plain")
            for which in order:
                ms[which].append(_event_ms(torch, fns[which], burst))
        times[name] = (statistics.median(ms["kernel"]), statistics.median(ms["plain"]))
        say(f"  {name} ({n} chains{', T = %d' % MULTI_T if lead else ''}, L = "
            f"{NUM_STEPS}): kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms; kernel quartiles "
            f"{[round(x, 4) for x in statistics.quantiles(ms['kernel'], n=4)]}")
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
    from mcmc_tpu_torch.ops import fused_trajectory as ft

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
    phase_philox_stats(torch, targets, samplers, dev)

    expected = {
        "grahmc_step_kernel": TUNE_BATCHES * TUNE_BATCH_LEN
        + TIMED_SAMPLES * (1 + TIMED_REPS) + 2 * ESS_SAMPLES,
        "grahmc_multistep_kernel": MULTI_SAMPLES // MULTI_T,
    }
    kernels = {"grahmc_step_kernel": ft.grahmc_step_kernel,
               "grahmc_multistep_kernel": ft.grahmc_multistep_kernel}
    for k in kernels.values():
        k.launches = 0
    step = phase_main_path(torch, ft, targets, samplers, tuning, diagnostics, dev)
    launches = {name: k.launches for name, k in kernels.items()}
    say(f"  launches on the main path: {launches} (expected {expected})")
    for name in kernels:
        require(launches[name] > 0 and launches[name] == expected[name],
                f"{name} launched {launches[name]} times, expected {expected[name]}")

    times = phase_timing(torch, ft, targets, step, dev)
    say(f"[7] done in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in kernels]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
