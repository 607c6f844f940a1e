"""Kernel 1's warp-per-chain instances and its tempered variant 1b, in lane
groups, against the parent's kernels, on one CUDA card.

    python experiments/torch_step_kernel_timing.py --parent DIR [--tree .]
        [--patched NAME[+NAME...] ...] [--out _archive/step_out]
        [--work _archive/step] [--skip-timing] [--reps N]

DIR is an unpacked tree of the commit before the redesign (`git archive`;
its mcmc_tpu_torch/ alone is enough); --tree the tree under test. Each
--patched adds the variant NAME: a copy of the tree's mcmc_tpu_torch/
under --work with the edits PATCHES[NAME] applied (several joined by "+")
and only kernels 1, 2, 1b and 1c built (TRAJECTORY_SOURCES; kernels 3 and
4 are left out of its outputs and times). The edits: "lanes-32", every
chain warp per chain (step_lanes 32: the parent's layout); "least-lanes",
the fewest lanes at every chain count (no MIN_GROUP_WARPS);
"min-warps-1024", that bound halved; "lanes-16", lane groups of at least
16 lanes at every K; "lanes-8", 8 at K <= 2; "friction-once", the
substeps' friction factors computed once a group of lanes and shared by
shuffles in every kernel (1c and kernel 1's warp-per-chain instances
too); "philox-once", each Philox block drawn once a chain at G = 32 too;
"no-friction-once" and "no-philox-once", every factor computed on every
lane, every block drawn once a coordinate; and the probe "unfolded" (a lane
adds all its registers in turn, then the butterfly over G lanes: not the
warp-per-chain order, so its grouped outputs differ; PROBES). The script

1. builds every tree's kernel library, one process per tree, a few at once;
2. prints each kernel instance's ptxas line (registers, spills) that
   differs between the parent and the tree, the instances the tree adds or
   drops (kernel 1's and 1b's warp-per-chain instances carry G = 32 in
   their names now and are compared with the parent's under that name),
   and the lane-group instances' lines;
3. runs every tree on the same inputs and compares each output's sha256
   digest with the parent's: kernel 1 and 1b on every family they
   dispatch at D 1, 2, 4, 8, 9, 16, 17, 32, 33, 50, 64, 65, 128 (the 2-
   and 3-D families at theirs) and 1, 7, 33 chains, at 8,191 chains at D
   10 and 50, under every schedule (NO_FRICTION, L 3; constant, L 16;
   tanh, L 64; sigmoid, L 1; linear, L 0; sine, L 7), injected draws and
   Philox; 1b in three rungs of a third of the chains (333 a rung at 999
   chains: a warp's chains in two rungs) and in one rung; kernel 2 (T =
   3) and 1c on every family at D 10 and 50; kernels 3 (T = 8) and 4 (two
   windows, endpoint and multinomial, diagonal and dense) on the nine
   families whose functors are per-coordinate sums (the four that run in
   lane groups among them) at D 10 and 50; 1a and 1d at one shape each;
4. times, in turns (parent, tree, variants, then back), with CUDA events
   around bursts enqueued while the card sleeps (chip_smoke.py's
   _event_ms), Philox mode unless named: kernel 1 at 65,536 x 50 on the
   funnel, L 16, the constant schedule (chip_smoke.py's [6]) and its
   probes (the NO_FRICTION schedule, injected draws, N(0, I) at D 50, the
   funnel at D 64); 1b at the tempered row's 6 x 8,192 x 10 (the mixture,
   tanh, L 16; [6e]) and its probes (NO_FRICTION, injected); the shapes
   that must not lose: kernel 1 at 4,096 x 50 (the correlated Gaussian, L
   16), at the ChEES row's 2,048 x 20 (the non-centered funnel, no
   friction, L 1 to 4) and at the sweep's 1,024 x 10 (its five families,
   L 16); and the controls kernel 2 (4,096 x 50, T 8, L 16), 1c (65,536 x
   10, L 16), kernel 4 (65,536 x 50, the funnel) and 1a (65,536 x 50, the
   rho = 0.9 Gaussian's oracle metric). Each time is printed with its ns
   per chain-substep (chains x L x T).

Each measurement runs in a process of its own, in the tree it measures.
Prints the card's name and power limit; writes the build logs and the
times under --out, the digests under --work. Exits 1 if an output of a
tree that is not a probe differs from the parent's.
"""

import argparse
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HOLD_CYCLES = 5_000_000
BUILD_TREES = 4          # trees built at once (each runs one nvcc a source)
OUTPUT_WORKERS = 3       # trees whose outputs are computed at once
TRAJECTORY_SOURCES = ("fused_trajectory.cu", "fused_trajectory_families_1.cu",
                      "fused_trajectory_families_2.cu", "fused_trajectory_families_3.cu",
                      "fused_trajectory_scaled.cu", "fused_trajectory_bridged.cu")
LEAST = "    return K == 1 ? 4 : (K == 2 ? 8 : 16);"
RULE = "    if (static_cast<long long>(n_chains) * g >= 32LL * MIN_GROUP_WARPS) return g;"
WARPS = "constexpr int MIN_GROUP_WARPS = 2048;"
SHARED = "bool SHARED_FRICTION = (G < 32)"
FRICTION = "      if constexpr (SHARED_FRICTION) {\n        if ((i & (G - 1)) == 0)"
PHILOX = "    if constexpr (G < 32) {\n      __shared__"
FOLD = """#pragma unroll
    for (int w = M / 2; w > 0; w /= 2) {
#pragma unroll
      for (int m = 0; m < w; ++m) part[m] += part[m + w];
    }"""
PATCHES = {
    "lanes-32": (("trajectory.cuh", RULE, RULE.replace("return g", "return 32")),),
    "least-lanes": (("trajectory.cuh", RULE, "    return g;"),),
    "min-warps-1024": (("trajectory.cuh", WARPS, WARPS.replace("2048", "1024")),),
    "lanes-16": (("trajectory.cuh", LEAST, "    return 16;"),),
    "lanes-8": (("trajectory.cuh", LEAST, "    return K <= 2 ? 8 : 16;"),),
    "friction-once": (("trajectory.cuh", SHARED, "bool SHARED_FRICTION = true"),),
    "no-friction-once": (("trajectory.cuh", FRICTION,
                          FRICTION.replace("SHARED_FRICTION", "false")),),
    "philox-once": (("trajectory.cuh", PHILOX, PHILOX.replace("G < 32", "true")),),
    # every block drawn once a coordinate: philox_normal_row in the group's layout
    "no-philox-once": (("trajectory.cuh", PHILOX, PHILOX.replace("G < 32", "false")),
                       ("trajectory.cuh", "      philox_normal_row(p0,",
                        "      philox_normal_row<K, G>(p0,"),
                       ("philox.cuh", "template <int K>\n__device__ __forceinline__ void "
                        "philox_normal_row(", "template <int K, int G = 32>\n__device__ "
                        "__forceinline__ void philox_normal_row("),
                       ("philox.cuh", "    const int d = lane + 32 * r;\n    z[r] = 0.f;",
                        "    const int d = lane + G * r;\n    z[r] = 0.f;")),
    "unfolded": (("targets.cuh", FOLD,
                  "#pragma unroll\n    for (int m = 1; m < M; ++m) part[0] += part[m];"),),
}
PROBES = {"unfolded"}     # change the outputs on purpose
SIMPLE = ("standard_normal", "neals_funnel", "gaussian_mixture", "correlated_gaussian",
          "neals_funnel_noncentered", "ill_conditioned_gaussian", "student_t", "log_gamma",
          "log_gamma_unconstrained")
OTHER = ("rosenbrock",)
SMALL = {"multimodal_funnel_2d": (2,), "concentric_l1_2d": (2,), "concentric_l1_3d": (3,),
         "nested_l1_2d": (2,), "nested_l1_3d": (3,)}
DIMS = (1, 2, 4, 8, 9, 16, 17, 32, 33, 50, 64, 65, 128)
CHAINS = (1, 7, 33)
SCHEDULES = ((0, 3), (1, 16), (2, 64), (3, 1), (4, 0), (5, 7))   # (schedule id, L)
DEVICE = "cuda"          # "cpu" rehearses the workers with the plain versions
SWEEP = ("neals_funnel_noncentered", "ill_conditioned_gaussian", "student_t", "log_gamma",
         "log_gamma_unconstrained")


def digest(torch, x):
    """A tensor's bytes as a sha256 hex digest, every NaN written as one NaN."""
    if x is None:
        return None
    if x.is_floating_point():
        x = torch.where(x.isnan(), torch.full_like(x, float("nan")), x)
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def _state(torch, t, family, n, dim, g, dev):
    """Positions of `family` for n chains (random, in its support) and their
    lp and grad, float32."""
    if family == "log_gamma":
        q = torch.rand((n, dim), generator=g, device=dev) * 2.0 + 0.3
    elif t.init_sampler is not None:
        q = t.init_sampler(g, n)
    else:
        q = torch.randn((n, dim), generator=g, device=dev) * 0.8
    q = q.float().contiguous()
    if n > 1 and dim > 3:
        q[1, 3] = -0.0
    lp, grad = (x.float().contiguous() for x in t.value_and_grad_fn(q))
    return q, lp, grad


def _target(family, dim):
    from mcmc_tpu_torch.targets import get_target
    return get_target(family, dim=dim)


def step_outputs(torch, full):
    """Kernels 1 and 1b (and, with `full`, 2, 1c, 3, 4, 1a, 1d) on the cases
    of step 3: {label: [output digests]}."""
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    dev = torch.device(DEVICE)
    key = torch.tensor([11, -12], dtype=torch.int32, device=dev)
    shapes = [(f, d, n) for f in SIMPLE + OTHER for d in DIMS for n in CHAINS
              if not (f == "rosenbrock" and d < 2)]
    shapes += [(f, d, 8191) for f in SIMPLE + OTHER for d in (10, 50)]
    shapes += [(f, d, n) for f, dims in SMALL.items() for d in dims for n in CHAINS + (999,)]
    shapes += [(f, 10, 999) for f in SIMPLE]
    out = {}
    for i, (family, dim, n) in enumerate(shapes):
        g = torch.Generator(device=dev).manual_seed(2000 + i)
        t = _target(family, dim)
        info = t.value_and_grad_fn.kernel_info
        q, lp, grad = _state(torch, t, family, n, dim, g, dev)
        invm = torch.rand(dim, generator=g, device=dev) + 0.5
        p0 = torch.randn((n, dim), generator=g, device=dev)
        u = torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25)
        eps = 0.02 if family == "rosenbrock" else 0.15
        n_rungs = 3 if n % 3 == 0 else 1
        betas = torch.tensor([1.0, 0.3, 0.05], device=dev)[:n_rungs]
        table = ft.rung_table(eps / torch.sqrt(betas), 0.5, 2.0, betas, dev)
        beta_row = betas.repeat_interleave(n // n_rungs)
        slp, sgrad = (beta_row * lp).contiguous(), (beta_row[:, None] * grad).contiguous()
        for sched, L in SCHEDULES:
            args = (info, L, sched, q, lp, grad, ft.kernel_scalars(eps, 0.5, 2.0, dev), invm)
            sargs = (info, L, sched, q, slp, sgrad, table, invm)
            for mode, rand in (("injected", dict(p0=p0, u=u)), ("philox", dict(key=key, call=3))):
                label = f"{family} D{dim} C{n} sched{sched} L{L} {mode}"
                out[f"k1 {label}"] = [digest(torch, x)
                                      for x in ft.grahmc_step_kernel(*args, **rand)]
                out[f"k1b {label}"] = [digest(torch, x)
                                       for x in ft.grahmc_scaled_kernel(*sargs, **rand)]
    out.update(control_outputs(torch, key, full))
    return out


def control_outputs(torch, key, full):
    """Kernel 2 and 1c on every family at D 10 and 50; with `full`, kernels 3
    and 4 on the families whose functors changed, 1a and 1d."""
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    dev = torch.device(DEVICE)
    out = {}
    fams = [(f, d) for f in SIMPLE + OTHER for d in (10, 50)] + [
        (f, d) for f, dims in SMALL.items() for d in dims]
    for i, (family, dim) in enumerate(fams):
        g = torch.Generator(device=dev).manual_seed(7000 + i)
        t = _target(family, dim)
        info = t.value_and_grad_fn.kernel_info
        n = 1000
        q, lp, grad = _state(torch, t, family, n, dim, g, dev)
        invm = torch.rand(dim, generator=g, device=dev) + 0.5
        eps = 0.02 if family == "rosenbrock" else 0.15
        sc = ft.kernel_scalars(eps, 0.5, 2.0, dev)
        label = f"{family} D{dim} C{n}"
        out[f"k2 {label}"] = [digest(torch, x) for x in ft.grahmc_multistep_kernel(
            info, 8, ft.SCHEDULE_IDS["tanh"], 3, q, lp, grad, sc, invm, key=key, call=2)]
        base = ft.bridge_base(0.5, 2.0, dim, dev)
        bridge = ft.bridged_vag(ft.device_vag(info), torch.tensor(0.5, device=dev),
                                torch.tensor(base.log_norm, dtype=torch.float32, device=dev),
                                base.mean, base.inv_scale)
        blp, bgrad = bridge(q)
        out[f"k1c {label}"] = [digest(torch, x) for x in ft.grahmc_bridged_kernel(
            info, 8, ft.SCHEDULE_IDS["sigmoid"], q, blp.contiguous(), bgrad.contiguous(),
            ft.bridge_scalars(eps, 0.5, 1.0, 0.5, base.log_norm, dev), base.mean,
            base.inv_scale, invm, key=key, call=1)]
        if full and family in SIMPLE:
            out.update(k34_outputs(torch, key, family, t, info, q, lp, grad, g, label))
    if full:
        out.update(tiled_outputs(torch, key))
    return out


def k34_outputs(torch, key, family, t, info, q, lp, grad, g, label):
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.ops import fused_rwmh as fr
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.ops.padded_targets import device_lp
    from mcmc_tpu_torch.samplers import nuts_persistent as tn
    dev = q.device
    out = {}
    rlp = device_lp(info)(q).contiguous()
    out[f"k3 {label}"] = [digest(torch, x) for x in fr.rwmh_multistep_kernel(
        info, 8, q, rlp, fr.rwmh_scale(0.1, dev), 37, key=key, call=3)]
    dim = q.shape[1]
    a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
    metrics = {"diagonal": torch.rand(dim, generator=g, device=dev) * 0.5 + 0.5,
               "dense": a @ a.T / dim + 0.5 * torch.eye(dim, device=dev, dtype=torch.float64)}
    step = 0.1 if family in ("neals_funnel", "log_gamma") else 0.2
    for metric_name, metric in metrics.items():
        inv_mass, l_inv = ft.kernel_metric(metric)
        for multi in (False, True):
            st = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multi)
            for call in range(2):
                st = fn.nuts_window_kernel(info, 8, 4, 10, st, fn.nuts_scalars(step, 1000.0, dev),
                                           inv_mass, key=key, call=call, l_inv=l_inv)
            kind = "multinomial" if multi else "endpoint"
            out[f"k4 {metric_name} {kind} {label}"] = [digest(torch, x) for x in st]
    return out


def tiled_outputs(torch, key):
    """1a on the correlated Gaussian at 1,000 x 50 and 1d on config 5's
    posterior at 300 x 20 x 64 rows."""
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(8000)
    out = {}
    t = get_target("correlated_gaussian", dim=50)
    q, lp, grad = _state(torch, t, "correlated_gaussian", 1000, 50, g, dev)
    invm, l_inv = ft.prepare_dense_metric(t.true_cov.to(dev, torch.float64))
    out["1a D50 C1000"] = [digest(torch, x) for x in ft.grahmc_step_kernel(
        t.value_and_grad_fn.kernel_info, 8, ft.SCHEDULE_IDS["tanh"], q, lp, grad,
        ft.kernel_scalars(0.3, 0.5, 1.0, dev), invm, key=key, call=1, l_inv=l_inv)]
    h = get_target("hierarchical_logistic", dim=20, n_data=64)
    hq = (h.init_sampler(g, 300) * 2.0).float().contiguous()
    hlp, hgrad = (x.float().contiguous() for x in h.value_and_grad_fn(hq))
    out["1d D20 C300"] = [digest(torch, x) for x in ft.grahmc_step_kernel(
        h.value_and_grad_fn.kernel_info, 8, ft.SCHEDULE_IDS["tanh"], hq, hlp, hgrad,
        ft.kernel_scalars(0.05, 0.5, 1.0, dev), torch.ones(20, device=dev), key=key, call=1)]
    return out


def _event_ms(torch, fn, burst):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(burst):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / burst


def timed_cases(torch, full):
    """{name: (fn, chain-substeps a call)} of step 4."""
    import chip_smoke as cs
    from mcmc_tpu_torch import samplers
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.samplers import nuts_persistent as tn
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device(DEVICE)
    key = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    cases = {}
    const, tanh = ft.SCHEDULE_IDS["constant"], ft.SCHEDULE_IDS["tanh"]

    def k1(name, family, n, dim, L, sched, step, injected=False):
        t = get_target(family, dim=dim)
        q = torch.randn((n, dim), generator=g, device=dev) * 0.5
        if family == "log_gamma":
            q = q.abs() + 0.3
        lp, grad = (x.float().contiguous() for x in t.value_and_grad_fn(q))
        args = (t.value_and_grad_fn.kernel_info, L, sched, q, lp, grad,
                ft.kernel_scalars(step, cs.GAMMA, cs.STEEPNESS, dev), torch.ones(dim, device=dev))
        rand = dict(key=key, call=0)
        if injected:
            rand = dict(p0=torch.randn((n, dim), generator=g, device=dev),
                        u=torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25))
        cases[name] = (lambda: ft.grahmc_step_kernel(*args, **rand), n * L)

    k1("k1 funnel 65,536 x 50", "neals_funnel", 65536, 50, 16, const, cs.PARITY_STEP)
    k1("k1 funnel no-friction", "neals_funnel", 65536, 50, 16, 0, cs.PARITY_STEP)
    k1("k1 funnel injected", "neals_funnel", 65536, 50, 16, const, cs.PARITY_STEP, True)
    k1("k1 N(0, I) 65,536 x 50", "standard_normal", 65536, 50, 16, const, 0.2)
    k1("k1 funnel 65,536 x 64", "neals_funnel", 65536, 64, 16, const, cs.PARITY_STEP)
    k1("k1 correlated 4,096 x 50", "correlated_gaussian", 4096, 50, 16, const, 0.1)
    for L in (1, 2, 3, 4):
        k1(f"k1 ChEES 2,048 x 20 L{L}", "neals_funnel_noncentered", 2048, 20, L, 0, 0.4)
    for family in SWEEP:
        k1(f"k1 sweep 1,024 x 10 {family}", family, 1024, 10, 16, const, 0.3)

    t = get_target("gaussian_mixture", dim=cs.TEMP_DIM)
    info = t.value_and_grad_fn.kernel_info
    betas = samplers.geometric_ladder(cs.TEMP_K, cs.TEMP_BETA_MIN, device=dev)
    n = cs.TEMP_K * cs.TEMP_CHAINS
    state = cs._mixture_state(torch, t, n, 44, dev, betas.repeat_interleave(cs.TEMP_CHAINS))
    table = ft.rung_table(cs.TEMP_STEP / torch.sqrt(betas), cs.TEMP_GAMMA, cs.TEMP_STEEP, betas,
                          dev)
    ones = torch.ones(cs.TEMP_DIM, device=dev)
    p0 = torch.randn((n, cs.TEMP_DIM), generator=g, device=dev)
    u = torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25)
    for name, sched, rand in (("1b 6 x 8,192 x 10", tanh, dict(key=key, call=0)),
                              ("1b no-friction", 0, dict(key=key, call=0)),
                              ("1b injected", tanh, dict(p0=p0, u=u))):
        args = (info, cs.TEMP_L, sched, *state, table, ones)
        cases[name] = (lambda a=args, r=rand: ft.grahmc_scaled_kernel(*a, **r), n * cs.TEMP_L)

    f = get_target("neals_funnel", dim=50)
    q = torch.randn((4096, 50), generator=g, device=dev) * 0.5
    lp, grad = (x.contiguous() for x in f.value_and_grad_fn(q))
    a2 = (f.value_and_grad_fn.kernel_info, 16, const, 8, q, lp, grad,
          ft.kernel_scalars(cs.PARITY_STEP, 1.0, 1.0, dev), torch.ones(50, device=dev))
    cases["k2 4,096 x 50 T 8"] = (lambda: ft.grahmc_multistep_kernel(*a2, key=key, call=0),
                                  4096 * 16 * 8)
    q = t.init_sampler(g, 65536)
    base = ft.bridge_base(None, cs.SMC_BASE_SCALE, cs.TEMP_DIM, dev)
    blp, bgrad = ft.bridged_vag(ft.device_vag(info), torch.tensor(0.5, device=dev),
                                torch.tensor(base.log_norm, dtype=torch.float32, device=dev),
                                base.mean, base.inv_scale)(q)
    a1c = (info, 16, 0, q, blp.contiguous(), bgrad.contiguous(),
           ft.bridge_scalars(cs.SMC_STEP, 0.0, 1.0, 0.5, base.log_norm, dev), base.mean,
           base.inv_scale, ones)
    cases["1c 65,536 x 10"] = (lambda: ft.grahmc_bridged_kernel(*a1c, key=key, call=0),
                               65536 * 16)
    c = get_target("correlated_gaussian", dim=50, correlation=0.9)
    cq = torch.randn((65536, 50), generator=g, device=dev) * 0.5
    clp, cgrad = c.value_and_grad_fn(cq)
    invm, l_inv = ft.prepare_dense_metric(c.true_cov.to(dev, torch.float64))
    a1a = (c.value_and_grad_fn.kernel_info, 16, const, cq, clp.contiguous(), cgrad.contiguous(),
           ft.kernel_scalars(0.3, 1.0, 1.0, dev), invm)
    cases["1a 65,536 x 50"] = (lambda: ft.grahmc_step_kernel(*a1a, key=key, call=0,
                                                             l_inv=l_inv), 65536 * 16)
    if full:
        wq = torch.randn((65536, 50), generator=g, device=dev) * 0.5
        wlp, wgrad = f.value_and_grad_fn(wq)
        st = tn._init_pstate(wq, wlp, wgrad, torch.float32, multinomial=False, max_tree_depth=10)
        wargs = (f.value_and_grad_fn.kernel_info, 16, 4, 10)
        sc = fn.nuts_scalars(0.2, 1000.0, dev)
        ones50 = torch.ones(50, device=dev)
        for call in range(2):       # two windows in, as chip_smoke.py times them
            st = fn.nuts_window_kernel(*wargs, st, sc, ones50, key=key, call=call)
        cases["k4 65,536 x 50"] = (lambda: fn.nuts_window_kernel(*wargs, st, sc, ones50,
                                                                 key=key, call=2), None)
    return cases


def worker_time(torch, full, reps, burst=10):
    cases = timed_cases(torch, full)
    ms, per = {}, {}
    for name, (run, substeps) in cases.items():
        run()
        ms[name] = [_event_ms(torch, run, burst) for _ in range(reps)]
        per[name] = substeps
    print("TIMES " + json.dumps({"ms": ms, "substeps": per}))


def worker(args):
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))   # chip_smoke.py's inputs
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    full = (root / "mcmc_tpu_torch" / "csrc" / "fused_nuts.cu").exists()
    if args.worker == "build":
        from mcmc_tpu_torch.ops import _cuda
        lib = _cuda.load_library()
        Path(args.save).write_text(lib.build_log)
        print(f"built {lib.path.name} in {lib.build_seconds:.1f} s")
    elif args.worker == "outputs":
        t0 = time.perf_counter()
        out = step_outputs(torch, full)
        torch.cuda.synchronize()
        Path(args.save).write_text(json.dumps(out))
        print(f"{len(out)} outputs' digests saved in {time.perf_counter() - t0:.1f} s")
    else:
        worker_time(torch, full, args.reps)


def run_worker(kind, root, save="", reps=10):
    cmd = [sys.executable, __file__, "--worker", kind, "--root", str(root), "--save", str(save),
           "--reps", str(reps)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    if proc.returncode:
        sys.exit(f"{kind} worker in {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return proc.stdout


def make_patched(tree, dst, names):
    """A copy of tree's mcmc_tpu_torch under dst, cut to TRAJECTORY_SOURCES,
    with the edits of each of `names` (PATCHES) applied."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(Path(tree) / "mcmc_tpu_torch", dst / "mcmc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = dst / "mcmc_tpu_torch" / "csrc"
    for src in csrc.glob("*.cu"):
        if src.name not in TRAJECTORY_SOURCES:
            src.unlink()
    cuda = dst / "mcmc_tpu_torch" / "ops" / "_cuda.py"
    text = cuda.read_text()
    old = "        fn = getattr(lib, name)\n"
    if text.count(old) != 1:
        sys.exit(f"_cuda.py: {old!r} is not once there")
    cuda.write_text(text.replace(old, "        fn = getattr(lib, name, None)\n"
                                      "        if fn is None:\n            continue\n"))
    for patch in names:
        for name, old, new in PATCHES[patch]:
            path = csrc / name
            text = path.read_text()
            if text.count(old) != 1:
                sys.exit(f"{patch}: {old!r} is not once in {name}")
            path.write_text(text.replace(old, new))
    return dst


def ptxas_lines(log):
    """{kernel's mangled name: its ptxas resource line and spill line}."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, spill = entry.group(1), ""
        elif "spill" in line and name:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and name:
            out[name] = f"{line.split(':', 1)[-1].strip()}; {spill}"
            name = None
    return out


def with_lanes(name):
    """The parent's kernel-1 or 1b instance name with G = 32 added, as the
    tree names its warp-per-chain instances."""
    return re.sub(r"(grahmc_(?:step|scaled)_kernelILi\d+ELi\d+ELb[01]E)E", r"\1Li32EE", name)


def compare_ptxas(lines):
    old = {with_lanes(k): v for k, v in lines["parent"].items()}
    new = lines["tree"]
    changed = sorted(k for k in set(old) & set(new) if old[k] != new[k])
    print(f"[ptxas] parent {len(old)} instances, tree {len(new)}; {len(set(old) & set(new))} in "
          f"both, {len(changed)} of them changed", flush=True)
    for k in changed:
        print(f"  changed {k}: {old[k]} -> {new[k]}")
    for k in sorted(set(old) - set(new)):
        print(f"  drops {k}: {old[k]}")
    for k in sorted(set(new) - set(old)):
        print(f"  adds {k}: {new[k]}")
    return changed


def compare_outputs(trees, work):
    t0 = time.perf_counter()
    labels = list(trees)
    for i in range(0, len(labels), OUTPUT_WORKERS):
        procs = {label: subprocess.Popen(
            [sys.executable, __file__, "--worker", "outputs", "--root", str(trees[label]),
             "--save", str(work / f"outputs_{label}.json")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for label in labels[i:i + OUTPUT_WORKERS]}
        for label, proc in procs.items():
            text = proc.communicate(timeout=1800)[0]
            if proc.returncode:
                sys.exit(f"outputs worker in {trees[label]} failed:\n{text[-8000:]}")
            print(f"[outputs] {label}: {text.strip().splitlines()[-1]}", flush=True)
    a = json.loads((work / "outputs_parent.json").read_text())
    differ = []
    for label in labels[1:]:
        b = json.loads((work / f"outputs_{label}.json").read_text())
        keys = [k for k in a if k in b]
        bad = [k for k in keys if a[k] != b[k]]
        kinds = sorted({k.split()[0] for k in keys})
        probe = set(label.split("+")) & PROBES
        print(f"[outputs] {label} against parent: {len(keys)} calls ({', '.join(kinds)}) "
              f"compared bit for bit: {len(keys) - len(bad)} equal, {len(bad)} differ"
              + (" (a probe: differences expected)" if probe else ""), flush=True)
        for k in bad[:40]:
            print(f"  differs: {k}")
        if not probe:
            differ += [(label, k) for k in bad]
    print(f"[outputs] compared in {time.perf_counter() - t0:.1f} s", flush=True)
    return differ


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--tree", default=".")
    ap.add_argument("--out", default="_archive/step_out")
    ap.add_argument("--work", default="_archive/step")
    ap.add_argument("--patched", action="append", default=[], help="+".join(PATCHES))
    ap.add_argument("--skip-timing", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--worker", choices=("build", "outputs", "time"))
    ap.add_argument("--root")
    ap.add_argument("--save", default="")
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    if not args.parent:
        sys.exit("--parent is required")

    out, work = Path(args.out).resolve(), Path(args.work).resolve()
    out.mkdir(parents=True, exist_ok=True)
    work.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": Path(args.parent).resolve(), "tree": Path(args.tree).resolve()}
    for label in args.patched:
        if not set(label.split("+")) <= set(PATCHES):
            sys.exit(f"--patched {label}: not among {sorted(PATCHES)}")
        trees[label] = make_patched(trees["tree"], work / label.replace("+", "_"),
                                    label.split("+"))
    t0 = time.perf_counter()
    procs = {}
    for label, root in list(trees.items()):
        while sum(p.poll() is None for p in procs.values()) >= BUILD_TREES:
            time.sleep(1)
        procs[label] = subprocess.Popen(
            [sys.executable, __file__, "--worker", "build", "--root", str(root), "--save",
             str(out / f"build_{label}.log")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for label, proc in procs.items():
        text = proc.communicate(timeout=1800)[0]
        if proc.returncode:
            if label in ("parent", "tree"):
                sys.exit(f"build of {label} failed:\n{text[-8000:]}")
            print(f"[build] {label} failed, left out:\n{text[-3000:]}", flush=True)
            del trees[label]
            continue
        print(f"[build] {label}: {text.strip().splitlines()[-1]}", flush=True)
    print(f"[build] all trees in {time.perf_counter() - t0:.1f} s", flush=True)

    lines = {label: ptxas_lines((out / f"build_{label}.log").read_text()) for label in trees}
    compare_ptxas(lines)
    for label in trees:
        if label == "parent":
            continue
        grouped = sorted((k, v) for k, v in lines[label].items()
                         if re.search(r"grahmc_(?:step|scaled)_kernelI.*Li(4|8|16)EE", k))
        print(f"[ptxas] {label}: {len(grouped)} lane-group instances of kernels 1 and 1b:")
        for k, v in grouped:
            print(f"  {k}: {v}")
    differ = compare_outputs(trees, work)
    if args.skip_timing:
        return 1 if differ else 0

    results = {label: {} for label in trees}
    substeps = {}
    order = list(trees)
    for label in order + order[::-1]:
        text = run_worker("time", trees[label], reps=args.reps)
        got = json.loads(text.split("TIMES ", 1)[1].splitlines()[0])
        for k, v in got["ms"].items():
            results[label].setdefault(k, []).extend(v)
        substeps.update({k: v for k, v in got["substeps"].items() if v})
        print(f"[time] {label}: " + ", ".join(
            f"{k} {statistics.median(v):.4f} ({min(v):.4f}-{max(v):.4f})"
            for k, v in got["ms"].items()), flush=True)
    print("[time] by case: each tree's median [min-max] ms over every rep, and ns a "
          "chain-substep; the change against the parent's median:")
    for k in results["parent"]:
        base = statistics.median(results["parent"][k])
        cells = []
        for label, r in results.items():
            if k not in r:
                continue
            m = statistics.median(r[k])
            per = f", {1e6 * m / substeps[k]:.3f} ns" if k in substeps else ""
            cells.append(f"{label} {m:.4f} [{min(r[k]):.4f}-{max(r[k]):.4f}]{per}"
                         + ("" if label == "parent" else f" ({100 * (m / base - 1):+.1f}%)"))
        print(f"  {k}: " + "; ".join(cells))
    (out / "times.json").write_text(json.dumps({"card": smi, "times": results,
                                                "substeps": substeps}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
