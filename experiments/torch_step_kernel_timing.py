"""Kernel 1's warp-per-chain instances and its tempered variant 1b in lane
groups, kernel 3 with the accept draw in the lane group's spare lane,
kernel 2's block-tiled data form 2b, kernel 2 and 2a where their small
launches wait on each chain's stream, and the bridged variant 1c in lane
groups with its lp at a trajectory's last substep alone, against the
parent's kernels, on one CUDA card.

    python experiments/torch_step_kernel_timing.py --parent DIR [--tree .]
        [--patched NAME[+NAME...] ...] [--probe NAME[+NAME...] ...]
        [--out _archive/step_out] [--work _archive/step] [--skip-timing]
        [--reps N] [--cases REGEX] [--outputs GROUP[,GROUP...]] [--sass REGEX]
        [--other LABEL=DIR ...] [--keep SOURCE[,SOURCE...]] [--skip-sass]
        [--build-trees N] [--smc]

DIR is an unpacked tree of the commit before the redesign (`git archive`;
its mcmc_tpu_torch/ alone is enough); --tree the tree under test. Each
--patched adds the variant NAME: a copy of the tree's mcmc_tpu_torch/
under --work with the edits PATCHES[NAME] applied (several joined by "+")
and only the sources those edits touch built (TRAJECTORY_SOURCES: kernels
1, 2, 1b and 1c; BRIDGED_SOURCES: 1c; RWMH_SOURCES: kernel 3; the other
kernels are left out of its outputs and times); each --probe the same on a
copy of the parent; each --other a variant LABEL copied unpatched from
another unpacked tree DIR, its TRAJECTORY_SOURCES alone. --keep cuts every
tree, the parent and the tree too, to the sources it names (1c's alone
builds in a few minutes where every kernel takes ~3).
The edits: "lanes-32", every chain warp per chain (step_lanes 32: the
parent's layout); "least-lanes", the fewest lanes at every chain count (no
MIN_GROUP_WARPS); "min-warps-1024", that bound halved; "lanes-16", lane
groups of at least 16 lanes at every K; "lanes-8", 8 at K <= 2;
"friction-once", the substeps' friction factors computed once a group of
lanes and shared by shuffles in every kernel (1c and kernel 1's
warp-per-chain instances too); "philox-once", each Philox block drawn once
a chain at G = 32 too; "no-friction-once" and "no-philox-once", every
factor computed on every lane, every block drawn once a coordinate; the
probe "unfolded" (a lane adds all its registers in turn, then the
butterfly over G lanes: not the warp-per-chain order, so its grouped
outputs differ; PROBES). Kernel 3's, for --probe on the parent:
"u-hash", the accept uniform from a three-instruction hash of (chain, t)
in place of its Philox block (the block's share of the time; its outputs
differ, PROBES); "threads-64" and "threads-128", blocks of 64 or 128
threads at every chain count; "sized-blocks", the most threads a block of
(256, 128, 64) that still give each of the card's 132 SMs a block (the
tree's launch_threads); and for --patched on the tree "log-u-late", the
logarithm of an injected u taken after the target, where the parent takes
it. Kernel 2's (K2_STEPS), for --patched: "no-STEP" and "only-STEP" take
out STEP or every other step ("k2-none" all): "lp-last", the log-density
summed at a trajectory's last substep alone; "lanes", the GROUPED_FAMILY
targets' lane groups; "sized-blocks", blocks of 4 or 2 warps where 8
leave an SM without one; "min-blocks-2", __launch_bounds__'s two blocks
an SM where a lane holds 2 or more registers; and "k2-bound-everywhere",
two blocks an SM at every instance. Its probes on the parent:
"butterfly-16", the warp's sums over 16 lanes (its outputs differ,
PROBES); "k2-threads-64" and "k2-threads-128", kernels 1 and 2 in blocks
of 64 or 128 threads. 1c's (C1_STEPS), for --patched: "no-1c-STEP" and
"only-1c-STEP" ("1c-none" all): "lanes", the grouped families' diagonal
instances in kernel 1's lane groups; "lp-last", the log-density summed at
a trajectory's last substep alone; "friction-once", the lane groups'
shared friction factors; its register budgets "1c-bound-B" (B blocks an SM
at every instance) and "1c-bound-none" (no minimum); and the funnel's
log-density in 1c as nvcc fuses it at each instance ("funnel-lp-nvcc";
1c writes out the fusion of its warp instances). The script

1. builds every tree's kernel library, one process per tree, a few at once;
2. prints each kernel instance's ptxas line (registers, spills) that
   differs between the parent and the tree, the instances the tree adds or
   drops (kernel 1's and 1b's warp-per-chain instances carry G = 32 in
   their names now and are compared with the parent's under that name),
   the lane-group instances' lines, each tree's 1c instances that spill
   more than the parent's (a lane-group instance against the parent's
   warp instance), and, unless --skip-sass, for kernel 3 (`cuobjdump -sass` of
   each library), every instance's SASS instructions in all and in its
   transition loop (the largest backward branch's span: both arms of its
   uniform branches and the transcendentals' rare slow paths included, so
   more than a transition executes) with its ptxas line, and the same spans
   of kernel 2's timed instances (K2_TIMED) with their substep loop's;
   --sass writes the SASS of the functions it names under --out/sass/<tree>/;
3. runs every tree on the same inputs and compares each output's sha256
   digest with the parent's (--outputs picks the groups, all by default):
   "step", kernel 1 and 1b on every family they dispatch at D 1, 2, 4, 8,
   9, 16, 17, 32, 33, 50, 64, 65, 128 (the 2- and 3-D families at theirs)
   and 1, 7, 33 chains, at 8,191 chains at D 10 and 50, under every
   schedule (NO_FRICTION, L 3; constant, L 16; tanh, L 64; sigmoid, L 1;
   linear, L 0; sine, L 7), injected draws and Philox; 1b in three rungs
   of a third of the chains (333 a rung at 999 chains: a warp's chains in
   two rungs) and in one rung; "control", kernel 2 (T = 3) and 1c on every
   family at D 10 and 50, and kernels 3 (T = 8) and 4 (two windows,
   endpoint and multinomial, diagonal and dense) on the nine families
   whose functors are per-coordinate sums at D 10 and 50, 1a and 1d at one
   shape each; "rwmh", kernel 3 on all 14 families (the hierarchical
   posterior's 3a at 256 rows) at D 1-128 around every lane-group edge,
   1-4,099 chains (N(0, I) at every D from 1 to 128, and 65,536 chains at
   D 2 and 10), both draw modes; "multistep", 2b under both metrics at D
   9, 20 and 100 with 64 and 256 rows, T 1, 2, 4 and 8, 1, 31, 33 and
   4,099 chains, both draw modes; "kernel2", kernel 2 and 2a on every family
   at D 1-128 and 1-16,385 chains (K2_DIMS, K2_CHAINS, K2_GROUPS), every
   schedule, L 0-64, T 1-8, both metrics and draw modes; "bridged", 1c on
   the four grouped families at D 1-128 and 1-65,536 chains
   (BRIDGED_DIMS, BRIDGED_CHAINS), beta 0-1, no friction and tanh, L 0-16
   (BRIDGED_SETTINGS), and on every family warp per chain under both
   metrics, both draw modes; a variant tree computes only the groups of
   VARIANT_GROUPS;
4. times, in turns (parent, tree, variants, then back), with CUDA events
   around bursts enqueued while the card sleeps (chip_smoke.py's
   _event_ms), Philox mode unless named, the cases --cases selects (all
   by default): kernel 1 at 65,536 x 50 on the funnel, L 16, the constant
   schedule (chip_smoke.py's [6]) and its probes (the NO_FRICTION
   schedule, injected draws, N(0, I) at D 50, the funnel at D 64); 1b at
   the tempered row's 6 x 8,192 x 10 (the mixture, tanh, L 16; [6e]) and
   its probes (NO_FRICTION, injected); kernel 1 at 4,096 x 50 (the
   correlated Gaussian, L 16), at the ChEES row's 2,048 x 20 (the
   non-centered funnel, no friction, L 1 to 4) and at the sweep's 1,024 x
   10 (its five families, L 16); kernel 2 (4,096 x 50, T 8, L 16), 1c
   (65,536 x 10, L 16), kernel 4 (65,536 x 50, the funnel) and 1a (65,536 x
   50, the rho = 0.9 Gaussian's oracle metric); kernel 3 at the RWMH row's
   65,536 x 10, T 32 (Philox, and both draws injected), on the sweep's five
   families at 1,024 x 10, T 16, and on [6h]'s three RAHMC families at
   1,024 x 2, T 16; 3a at 8,192 x 100, 256 rows, T 32; 2b at config 5's
   4,096 x 100, 256 rows, T 8, L 16 (tanh), and 1d at 8,192 x 100, L 16;
   kernel 2 and 2a at the paths' other shapes (multi_cases); 1c at beta
   0.5 at [6e]'s 65,536 x 10, L 16 (no friction, and tanh) and the SMC
   row's 32,768 x 10, L 8, Philox and injected (bridged_cases).
   Each time is printed with its ns per chain-substep (chains x L x T; a
   chain-transition for kernel 3);
5. with --smc, chip_smoke.py's SMC row [5i] and move-dominated pair [5j]
   on the parent's and the tree's kernels in turns: rates and device-busy
   shares.

Each measurement runs in a process of its own, in the tree it measures.
Prints the card's name, power limit and SM clocks (before and after the
timings); writes the build logs and the times under --out, the digests
under --work. Exits 1 if an output of a tree that is not a probe differs
from the parent's.
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
K2_BOUNDS = ("__launch_bounds__(WARPS_PER_BLOCK * 32, "
             "(K * 32 / G > 1 ? MULTI_MIN_BLOCKS : 1))")
RWMH_LAUNCH = ("    const long long chains_per_block = (THREADS / 32) * (32 / G);\n"
               "    const unsigned blocks = static_cast<unsigned>((a.n_chains + chains_per_block - 1) /\n"
               "                                                  chains_per_block);\n"
               "    rwmh_multistep_kernel<FAMILY, G><<<blocks, THREADS, 0, stream>>>(a);")
U_DRAW = "      u = philox_accept_uniform(chain, a.call, static_cast<uint32_t>(t), k0, k1);"
SIZED = ("    int threads = THREADS;  // the most that still give every SM a block\n"
         "    while (threads > 64 && (a.n_chains + (threads / 32) * (32 / G) - 1) /\n"
         "                               ((threads / 32) * (32 / G)) < 132) threads /= 2;\n"
         + RWMH_LAUNCH.replace("(THREADS / 32)", "(threads / 32)").replace(
             "<<<blocks, THREADS,", "<<<blocks, threads,"))
PATCHES.update({
    "u-hash": (("fused_rwmh.cu", U_DRAW,
                "      u = bits_to_uniform((static_cast<uint32_t>(chain) * 0x9E3779B9u) ^\n"
                "                          (static_cast<uint32_t>(t) * 0x85EBCA6Bu) ^ k0);"),),
    "threads-64": (("fused_rwmh.cu", RWMH_LAUNCH, RWMH_LAUNCH.replace("THREADS", "64")),),
    "threads-128": (("fused_rwmh.cu", RWMH_LAUNCH, RWMH_LAUNCH.replace("THREADS", "128")),),
    "sized-blocks": (("fused_rwmh.cu", RWMH_LAUNCH, SIZED),),
    # the injected u's logarithm taken after the target, as the parent takes it
    "log-u-late": (("fused_rwmh.cu", "      log_u = logf(a.u[slot]);\n    }",
                    "      log_u = a.u[slot];\n    }"),
                   ("fused_rwmh.cu", "    const float lp1 = log_density(prop);\n",
                    "    const float lp1 = log_density(prop);\n"
                    "    if (!philox) log_u = logf(log_u);\n")),
})
# Kernel 2's design steps, as edits of fused_trajectory.cuh that take one
# out: "no-STEP" the tree without it, "only-STEP" the tree with it alone
# (the parent's kernel 2 with that step), "k2-none" the tree without any.
K2_STEPS = {
    "lp-last": ("    const bool accept = transition<G, true, true>(",
                "    const bool accept = transition<G, true, false>("),
    "lanes": ("    } else if constexpr (!DENSE) {\n      constexpr int LEAST",
              "    } else if constexpr (false) {\n      constexpr int LEAST"),
    "sized-blocks": ("constexpr int MIN_MULTI_WARPS = 2;",
                     "constexpr int MIN_MULTI_WARPS = WARPS_PER_BLOCK;"),
    "min-blocks-2": (K2_BOUNDS, "__launch_bounds__(WARPS_PER_BLOCK * 32)"),
}
for _step, (_old, _new) in K2_STEPS.items():
    PATCHES[f"no-{_step}"] = (("fused_trajectory.cuh", _old, _new),)
    PATCHES[f"only-{_step}"] = tuple(("fused_trajectory.cuh", o, n)
                                     for k, (o, n) in K2_STEPS.items() if k != _step)
PATCHES["k2-none"] = tuple(("fused_trajectory.cuh", o, n) for o, n in K2_STEPS.values())
# 1c's design steps, as edits of fused_trajectory_bridged.cu that take one
# out ("no-1c-STEP", "only-1c-STEP", "1c-none" as kernel 2's): "lanes", the
# GROUPED_FAMILY targets' diagonal instances in kernel 1's lane groups;
# "lp-last", the log-density summed at a trajectory's last substep alone;
# "friction-once", the lane groups' shared friction factors.
C1_STEPS = {
    "lanes": ("    constexpr int LEAST = DENSE ? 32 : least_lanes<FAMILY, K>();",
              "    constexpr int LEAST = 32;"),
    "lp-last": ("  static constexpr bool PEELS = TAKES_WITH_LP<T, K>;",
                "  static constexpr bool PEELS = false;"),
    "friction-once": ("    step_chain<N, G, true, P::PEELS>(",
                      "    step_chain<N, G, false, P::PEELS>("),
}
for _step, (_old, _new) in C1_STEPS.items():
    PATCHES[f"no-1c-{_step}"] = (("fused_trajectory_bridged.cu", _old, _new),)
    PATCHES[f"only-1c-{_step}"] = tuple(("fused_trajectory_bridged.cu", o, n)
                                        for k, (o, n) in C1_STEPS.items() if k != _step)
PATCHES["1c-none"] = tuple(("fused_trajectory_bridged.cu", o, n) for o, n in C1_STEPS.values())
# 1c's register budget: __launch_bounds__'s minimum of blocks an SM at every
# instance ("1c-bound-B"), or none ("1c-bound-none")
C1_BUDGET = "  return K * 32 / G > 1 ? 2 : 1;\n}"
C1_BOUNDS = "__launch_bounds__(WARPS_PER_BLOCK * 32, (bridged_min_blocks<K, G>()))"
for _b in (1, 2, 3):
    PATCHES[f"1c-bound-{_b}"] = (("fused_trajectory_bridged.cu", C1_BUDGET,
                                  f"  return {_b};\n}}"),)
PATCHES["1c-bound-none"] = (("fused_trajectory_bridged.cu", C1_BOUNDS,
                             "__launch_bounds__(WARPS_PER_BLOCK * 32)"),)
# kernel 2's two blocks an SM at every instance, one register a lane too
PATCHES["k2-bound-everywhere"] = (("fused_trajectory.cuh", K2_BOUNDS, K2_BOUNDS.replace(
    "(K * 32 / G > 1 ? MULTI_MIN_BLOCKS : 1))", "MULTI_MIN_BLOCKS)")),)
# probes on the parent: the warp's sums over its first 16 lanes (4 butterfly
# levels, the least power of two >= D at D 9-16; lanes 16-31 get their own
# sums, so its outputs may differ), and kernels 1 and 2 in blocks of 64 or
# 128 threads at every chain count (only kernel 2's times are read)
PATCHES.update({
    "butterfly-16": (("targets.cuh", "  for (int offset = G / 2; offset > 0; offset >>= 1) {",
                      "  for (int offset = G == 32 ? 8 : G / 2; offset > 0; offset >>= 1) {"),),
    "k2-threads-64": (("trajectory.cuh", "constexpr int WARPS_PER_BLOCK = 8;",
                       "constexpr int WARPS_PER_BLOCK = 2;"),),
    "k2-threads-128": (("trajectory.cuh", "constexpr int WARPS_PER_BLOCK = 8;",
                        "constexpr int WARPS_PER_BLOCK = 4;"),),
})
# 1c with the funnel's log-density's sum_sq inv_var + d_rest x0 left to
# nvcc, which fuses one product or the other by the instance (1c's lane
# groups not as its warp instances did; fused_trajectory_bridged.cu writes
# the warp instances' out)
PATCHES["funnel-lp-nvcc"] = (("fused_trajectory_bridged.cu",
                              "      return target.template operator()<K * G == 32 ? 1 : 2>(q, g, lane);",
                              "      return target(q, g, lane);"),)
RWMH_SOURCES = ("fused_rwmh.cu",)
BRIDGED_SOURCES = ("fused_trajectory_bridged.cu",)
PROBES = {"unfolded", "u-hash", "butterfly-16", "funnel-lp-nvcc"}   # outputs may differ
OUTPUT_GROUPS = ("step", "control", "rwmh", "multistep", "kernel2", "bridged")
VARIANT_GROUPS = ("kernel2", "bridged")     # the groups a variant tree computes
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


def outputs(torch, groups, has):
    """The cases of step 3 in `groups` that the tree's sources build (`has`:
    "trajectory", "rwmh", "nuts"): {label: [output digests]}."""
    dev = torch.device(DEVICE)
    key = torch.tensor([11, -12], dtype=torch.int32, device=dev)
    out = {}
    if "step" in groups and has["trajectory"]:
        out.update(step_outputs(torch, key))
    if "control" in groups and has["trajectory"]:
        out.update(control_outputs(torch, key, has["rwmh"] and has["nuts"]))
    if "rwmh" in groups and has["rwmh"]:
        out.update(rwmh_outputs(torch, key))
    if "multistep" in groups and has["trajectory"]:
        out.update(multistep_outputs(torch, key))
    if "kernel2" in groups and has["trajectory"]:
        out.update(kernel2_outputs(torch, key))
    if "bridged" in groups and has["bridged"]:
        out.update(bridged_outputs(torch, key))
    return out


def step_outputs(torch, key):
    """Kernels 1 and 1b on the cases of step 3's "step" group."""
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    dev = torch.device(DEVICE)
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
    return out


# 1c's matrix: the GROUPED_FAMILY targets at BRIDGED_DIMS x BRIDGED_CHAINS
# (lane groups at 16,385 and 65,536 chains: 4 lanes at K = 1, 8 at K = 2,
# 16 at K >= 3; 16,385 leaves a warp one chain), each case two of
# BRIDGED_SETTINGS (beta, schedule, L) in turn, both draw modes; every family
# at D 10 and 50 (the 2- and 3-D families at theirs), both metrics, and the
# hierarchical posterior (20-D, 64 rows), at 1,000 chains (warp per chain)
BRIDGED_DIMS = (1, 2, 9, 10, 17, 32, 33, 64, 65, 128)
BRIDGED_CHAINS = (1, 7, 33, 16385, 65536)
BRIDGED_SETTINGS = tuple((beta, sched, L) for beta in (0.0, 0.05, 0.5, 1.0)
                         for sched in (0, 2) for L in (0, 1, 8, 16))


def bridged_outputs(torch, key):
    """1c on BRIDGED_DIMS x BRIDGED_CHAINS of the grouped families and on
    every family's warp-per-chain instances, diagonal and dense."""
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device(DEVICE)
    cases = [(f, d, n, False) for f in ("standard_normal", "neals_funnel", "gaussian_mixture",
                                        "correlated_gaussian")
             for d in BRIDGED_DIMS for n in BRIDGED_CHAINS]
    cases += [(f, d, 1000, dense) for f in SIMPLE + OTHER for d in (10, 50)
              for dense in (False, True)]
    cases += [(f, d, 1000, dense) for f, dims in SMALL.items() for d in dims
              for dense in (False, True)]
    cases += [("hierarchical_logistic", 20, 1000, False)]
    out = {}
    j = 0
    for i, (family, dim, n, dense) in enumerate(cases):
        t = (get_target(family, dim=dim, n_data=64) if family == "hierarchical_logistic"
             else _target(family, dim))
        info = t.value_and_grad_fn.kernel_info
        g = torch.Generator(device=dev).manual_seed(17000 + i)
        q, _, _ = _state(torch, t, family, n, dim, g, dev)
        if dense:
            a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
            invm, l_inv = ft.prepare_dense_metric(
                a @ a.T / dim + 0.5 * torch.eye(dim, device=dev, dtype=torch.float64))
        else:
            invm, l_inv = torch.rand(dim, generator=g, device=dev) + 0.5, None
        p0 = torch.randn((n, dim), generator=g, device=dev)
        if dense:
            p0 = ft.unwhiten(p0, invm, l_inv)
        u = torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25)
        base = ft.bridge_base(0.5, 2.0, dim, dev)
        eps = 0.02 if family == "rosenbrock" else 0.15
        for _ in range(2):
            beta, sched, L = BRIDGED_SETTINGS[j % len(BRIDGED_SETTINGS)]
            j += 1
            potential = ft.bridged_vag(ft.device_vag(info), torch.tensor(beta, device=dev),
                                       torch.tensor(base.log_norm, dtype=torch.float32,
                                                    device=dev), base.mean, base.inv_scale)
            blp, bgrad = (x.float().contiguous() for x in potential(q))
            args = (info, L, sched, q, blp, bgrad,
                    ft.bridge_scalars(eps, 0.5, 2.0, beta, base.log_norm, dev), base.mean,
                    base.inv_scale, invm)
            label = (f"k1c {'dense' if dense else 'diagonal'} {family} D{dim} C{n} beta{beta} "
                     f"sched{sched} L{L}")
            for mode, rand in (("injected", dict(p0=p0.contiguous(), u=u)),
                               ("philox", dict(key=key, call=5))):
                out[f"{label} {mode}"] = [digest(torch, x) for x in ft.grahmc_bridged_kernel(
                    *args, l_inv=l_inv, **rand)]
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


# kernel 3's D: every lane-group edge (G 1, 2, 4, 8, 16, 32 fill at D 4, 8,
# 16, 32, 64, 128; a spare lane at D 9-12, 17-28, 33-60, 65-124)
RWMH_DIMS = (1, 2, 3, 4, 5, 8, 9, 10, 12, 13, 16, 17, 20, 28, 29, 32, 33, 50, 60, 61, 64,
             65, 100, 124, 125, 128)
RWMH_CHAINS = (1, 7, 33, 999, 4099)
MULTI_DIMS, MULTI_ROWS, MULTI_COUNTS = (9, 20, 100), (64, 256), (1, 31, 33, 4099)   # 2b's


def rwmh_outputs(torch, key):
    """Kernel 3 (T = 8, a 37-chain history) on every family at RWMH_DIMS
    (the 2- and 3-D families at theirs; N(0, I) at every D 1-128 too, and
    at 65,536 chains at D 2 and 10), RWMH_CHAINS chains, injected draws and
    Philox; 3a (the hierarchical posterior, 256 rows) at D 2-128."""
    from mcmc_tpu_torch.ops import fused_rwmh as fr
    from mcmc_tpu_torch.ops.padded_targets import device_lp
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device(DEVICE)
    cases = [(f, d, n) for f in SIMPLE + OTHER for d in RWMH_DIMS for n in RWMH_CHAINS
             if not (f == "rosenbrock" and d < 2)]
    cases += [(f, d, n) for f, dims in SMALL.items() for d in dims for n in RWMH_CHAINS]
    cases += [("standard_normal", d, n) for d in range(1, 129) if d not in RWMH_DIMS
              for n in (7, 1031)]
    cases += [(f, d, 65536) for f in ("standard_normal", "student_t") for d in (2, 10)]
    cases += [("hierarchical_logistic", d, n) for d in (2, 5, 9, 12, 20, 33, 100, 128)
              for n in (1, 33, 999, 8191)]
    out = {}
    for i, (family, dim, n) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(9000 + i)
        t = (get_target(family, dim=dim, n_data=256) if family == "hierarchical_logistic"
             else _target(family, dim))
        info = t.value_and_grad_fn.kernel_info
        q, _, _ = _state(torch, t, family, n, dim, g, dev)
        lp = device_lp(info)(q).float().contiguous()
        scale = fr.rwmh_scale((0.1 if family == "rosenbrock" else 1.2) / dim ** 0.5, dev)
        noise = torch.randn((8, n, dim), generator=g, device=dev)
        u = torch.rand((8, n), generator=g, device=dev).clamp_min(2.0 ** -25)
        for mode, rand in (("injected", dict(noise=noise, u=u)), ("philox", dict(key=key, call=3))):
            out[f"k3 {family} D{dim} C{n} {mode}"] = [digest(torch, x) for x in
                                                      fr.rwmh_multistep_kernel(
                                                          info, 8, q, lp, scale, min(n, 37),
                                                          **rand)]
    return out


def multistep_outputs(torch, key):
    """2b (kernel 2 on the hierarchical posterior) under both metrics, L 8
    (tanh), at D 9, 20 and 100 with 64 and 256 rows, T 1, 2, 4, 8, at 1,
    31, 33 and 4,099 chains, injected draws and Philox."""
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device(DEVICE)
    out = {}
    i = 0
    for dim in MULTI_DIMS:
        for n_data in MULTI_ROWS:
            h = get_target("hierarchical_logistic", dim=dim, n_data=n_data)
            info = h.value_and_grad_fn.kernel_info
            for dense in (False, True):
                for transitions in (1, 2, 4, 8):
                    for n in MULTI_COUNTS:
                        i += 1
                        g = torch.Generator(device=dev).manual_seed(11000 + i)
                        q = (h.init_sampler(g, n) * 2.0).float().contiguous()
                        lp, grad = (x.float().contiguous() for x in h.value_and_grad_fn(q))
                        if dense:
                            a = torch.randn((dim, dim), generator=g, device=dev,
                                            dtype=torch.float64)
                            invm, l_inv = ft.prepare_dense_metric(
                                a @ a.T / dim + 0.5 * torch.eye(dim, device=dev,
                                                                dtype=torch.float64))
                        else:
                            invm = torch.rand(dim, generator=g, device=dev) * 0.5 + 0.25
                            l_inv = None
                        p0 = torch.randn((transitions, n, dim), generator=g, device=dev)
                        if dense:
                            p0 = ft.unwhiten(p0.reshape(-1, dim), invm, l_inv).reshape(
                                transitions, n, dim)
                        u = torch.rand((transitions, n), generator=g, device=dev).clamp_min(
                            2.0 ** -25)
                        args = (info, 8, ft.SCHEDULE_IDS["tanh"], transitions, q, lp, grad,
                                ft.kernel_scalars(0.1 if dense else 0.2, 0.5, 0.5, dev), invm)
                        label = (f"2b {'dense' if dense else 'diagonal'} D{dim} N{n_data} "
                                 f"T{transitions} C{n}")
                        for mode, rand in (("injected", dict(p0=p0.contiguous(), u=u)),
                                           ("philox", dict(key=key, call=2))):
                            out[f"{label} {mode}"] = [digest(torch, x) for x in
                                                      ft.grahmc_multistep_kernel(
                                                          *args, l_inv=l_inv, **rand)]
    return out


# kernel 2's and 2a's matrix: every family at K2_DIMS (the 2- and 3-D
# families at theirs), K2_CHAINS chains, and past MIN_GROUP_WARPS the
# grouped families' lane groups (16 lanes at 4,099 chains and K >= 3, 8 at
# 8,193 and K = 2, 4 at 16,385 and K = 1); each case one of SCHEDULES (L 0,
# 1, 3, 7, 16, 64) and T 1, 2 or 8 in turn, both metrics, both draw modes
K2_DIMS = (1, 2, 4, 9, 10, 16, 17, 32, 33, 50, 64, 65, 128)
K2_CHAINS = (1, 3, 33, 1024, 4099)
K2_GROUPS = ((33, 8193), (50, 8193), (64, 8193), (1, 16385), (2, 16385), (10, 16385),
             (32, 16385))


def kernel2_outputs(torch, key):
    """Kernel 2 (diagonal) and 2a on K2_DIMS x K2_CHAINS and K2_GROUPS."""
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    dev = torch.device(DEVICE)
    cases = [(f, d, n) for f in SIMPLE + OTHER for d in K2_DIMS for n in K2_CHAINS
             if not (f == "rosenbrock" and d < 2)]
    cases += [(f, d, n) for f, dims in SMALL.items() for d in dims for n in K2_CHAINS]
    cases += [(f, d, n) for f in ("standard_normal", "neals_funnel", "gaussian_mixture",
                                  "correlated_gaussian") for d, n in K2_GROUPS]
    out = {}
    for i, (family, dim, n) in enumerate(cases):
        t = _target(family, dim)
        info = t.value_and_grad_fn.kernel_info
        for dense in (False, True):
            j = 2 * i + dense
            g = torch.Generator(device=dev).manual_seed(13000 + j)
            q, lp, grad = _state(torch, t, family, n, dim, g, dev)
            sched, L = SCHEDULES[j % len(SCHEDULES)]
            T = (1, 2, 8)[j % 3]
            if dense:
                a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
                invm, l_inv = ft.prepare_dense_metric(
                    a @ a.T / dim + 0.5 * torch.eye(dim, device=dev, dtype=torch.float64))
            else:
                invm, l_inv = torch.rand(dim, generator=g, device=dev) + 0.5, None
            p0 = torch.randn((T, n, dim), generator=g, device=dev)
            if dense:
                p0 = ft.unwhiten(p0.reshape(-1, dim), invm, l_inv).reshape(T, n, dim)
            u = torch.rand((T, n), generator=g, device=dev).clamp_min(2.0 ** -25)
            eps = 0.02 if family == "rosenbrock" else 0.15
            args = (info, L, sched, T, q, lp, grad, ft.kernel_scalars(eps, 0.5, 2.0, dev), invm)
            label = (f"k2m {'dense' if dense else 'diagonal'} {family} D{dim} C{n} "
                     f"sched{sched} L{L} T{T}")
            for mode, rand in (("injected", dict(p0=p0.contiguous(), u=u)),
                               ("philox", dict(key=key, call=4))):
                out[f"{label} {mode}"] = [digest(torch, x) for x in ft.grahmc_multistep_kernel(
                    *args, l_inv=l_inv, **rand)]
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


def timed_cases(torch, has, pick):
    """{name: (fn, chain-substeps a call)} of step 4: the cases whose name
    `pick` (a compiled regex) finds, among those the tree's sources build."""
    cases = {}
    if has["trajectory"]:
        cases.update(step_cases(torch, has["nuts"]))
        cases.update(data_cases(torch, has["rwmh"]))
    if has["rwmh"]:
        cases.update(rwmh_cases(torch))
    if has["bridged"]:
        cases.update(bridged_cases(torch))
    return {k: v for k, v in cases.items() if pick.search(k)}


def bridged_cases(torch):
    """1c at beta 0.5 on the bridge from N(0, 6^2 I) to the 10-D mixture,
    Philox and injected: [5j]'s and [6e]'s 65,536 x 10, L 16 (no friction,
    and tanh) and the SMC row's 32,768 x 10, L 8 (no friction)."""
    import chip_smoke as cs
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device(DEVICE)
    key = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(10)
    t = get_target("gaussian_mixture", dim=cs.TEMP_DIM)
    info = t.value_and_grad_fn.kernel_info
    base = ft.bridge_base(None, cs.SMC_BASE_SCALE, cs.TEMP_DIM, dev)
    ones = torch.ones(cs.TEMP_DIM, device=dev)
    tanh = ft.SCHEDULE_IDS["tanh"]
    cases = {}
    for name, n, L, sched in (("1c 65,536 x 10", cs.MOVE_P, cs.MOVE_L, 0),
                              ("1c 65,536 x 10 tanh", cs.MOVE_P, cs.MOVE_L, tanh),
                              ("1c SMC 32,768 x 10 L 8", cs.SMC_P, cs.SMC_L, 0)):
        q = t.init_sampler(g, n)
        blp, bgrad = ft.bridged_vag(ft.device_vag(info), torch.tensor(0.5, device=dev),
                                    torch.tensor(base.log_norm, dtype=torch.float32,
                                                 device=dev), base.mean, base.inv_scale)(q)
        args = (info, L, sched, q, blp.contiguous(), bgrad.contiguous(),
                ft.bridge_scalars(cs.SMC_STEP, cs.TEMP_GAMMA, cs.TEMP_STEEP, 0.5,
                                  base.log_norm, dev), base.mean, base.inv_scale, ones)
        inj = dict(p0=torch.randn((n, cs.TEMP_DIM), generator=g, device=dev),
                   u=torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25))
        for label, rand in ((name, dict(key=key, call=0)), (f"{name} injected", inj)):
            cases[label] = (lambda a=args, r=rand: ft.grahmc_bridged_kernel(*a, **r), n * L)
    return cases


def rwmh_cases(torch):
    """Kernel 3 at the RWMH row's shape (Philox; both draws injected), the
    sweep's and [6h]'s 1,024-chain cells; a chain-transition a "substep"."""
    import chip_smoke as cs
    from mcmc_tpu_torch.ops import fused_rwmh as fr
    from mcmc_tpu_torch.ops.padded_targets import device_lp
    dev = torch.device(DEVICE)
    key = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    cases = {}

    def k3(name, family, n, dim, T, n_hist, scale, injected=False):
        t = _target(family, dim)
        info = t.value_and_grad_fn.kernel_info
        q = t.init_sampler(g, n) if t.init_sampler is not None else (
            torch.randn((n, dim), generator=g, device=dev) * 0.5)
        if family == "log_gamma":
            q = torch.rand((n, dim), generator=g, device=dev) * 2.0 + 0.3
        q = q.float().contiguous()
        lp = device_lp(info)(q).float().contiguous()
        args = (info, T, q, lp, fr.rwmh_scale(scale, dev), n_hist)
        rand = dict(key=key, call=0)
        if injected:
            rand = dict(noise=torch.randn((T, n, dim), generator=g, device=dev),
                        u=torch.rand((T, n), generator=g, device=dev).clamp_min(2.0 ** -25))
        cases[name] = (lambda: fr.rwmh_multistep_kernel(*args, **rand), n * T)

    k3("k3 65,536 x 10 T 32", "standard_normal", cs.RWMH_CHAINS, cs.RWMH_DIM, cs.RWMH_T,
       cs.RWMH_COLLECT, cs.RWMH_SCALE)
    k3("k3 65,536 x 10 injected", "standard_normal", cs.RWMH_CHAINS, cs.RWMH_DIM, cs.RWMH_T,
       cs.RWMH_COLLECT, cs.RWMH_SCALE, injected=True)
    for family in SWEEP:
        k3(f"k3 sweep 1,024 x 10 {family}", family, cs.SWEEP_CHAINS, cs.SWEEP_DIM,
           cs.SWEEP_RWMH_T, cs.SWEEP_CHAINS, 0.5)
    for family in ("multimodal_funnel_2d", "concentric_l1_2d", "nested_l1_2d"):
        k3(f"k3 [6h] 1,024 x 2 {family}", family, cs.RAHMC_CHAINS, 2, cs.RAHMC_RWMH_T,
           cs.RAHMC_CHAINS, 0.5)
    return cases


def data_cases(torch, rwmh=True):
    """Config 5's data forms: 2b at 4,096 x 100 (T 8) and the controls 1d
    (8,192 x 100) and, with `rwmh` (a tree that builds kernel 3), 3a (8,192
    x 100, T 32), 256 rows, from the target's init sampler, tanh, L 16."""
    import chip_smoke as cs
    from mcmc_tpu_torch.ops import fused_rwmh as fr
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device(DEVICE)
    key = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    h = get_target("hierarchical_logistic", dim=cs.HIER_DIM, n_data=cs.HIER_N_DATA)
    info = h.value_and_grad_fn.kernel_info
    q = h.init_sampler(g, cs.HIER_CHAINS).float().contiguous()
    lp, grad = (x.float().contiguous() for x in h.value_and_grad_fn(q))
    invm = torch.rand(cs.HIER_DIM, generator=g, device=dev) * 0.05 + 0.02
    sc = ft.kernel_scalars(0.05, 0.5, 1.0, dev)
    tanh = ft.SCHEDULE_IDS["tanh"]
    n = cs.HIER_MULTI_CHAINS
    a2 = (info, cs.HIER_L, tanh, cs.MULTI_T, q[:n].contiguous(), lp[:n].contiguous(),
          grad[:n].contiguous(), sc, invm)
    a1 = (info, cs.HIER_L, tanh, q, lp, grad, sc, invm)
    a3 = (info, cs.RWMH_T, q, lp, fr.rwmh_scale(0.02, dev), cs.COLLECT)
    cases = {"2b 4,096 x 100 x 256 T 8": (lambda: ft.grahmc_multistep_kernel(*a2, key=key, call=0),
                                          n * cs.HIER_L * cs.MULTI_T),
             "1d 8,192 x 100 x 256": (lambda: ft.grahmc_step_kernel(*a1, key=key, call=0),
                                      cs.HIER_CHAINS * cs.HIER_L)}
    if rwmh:
        cases["3a 8,192 x 100 x 256 T 32"] = (
            lambda: fr.rwmh_multistep_kernel(*a3, key=key, call=0), cs.HIER_CHAINS * cs.RWMH_T)
    return cases


def step_cases(torch, full):
    """Kernels 1, 1b, 2, 1a and, with `full`, kernel 4."""
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
    cases.update(multi_cases(torch, g, key))
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


def multi_cases(torch, g, key):
    """Kernel 2 and 2a at the paths' other shapes (T 8): [6h]'s three 2-D
    cells (1,024 chains, L 16, constant), the sweep's five families (1,024 x
    10, L 16, constant), Rosenbrock's 2a (1,024 x 10, L 64, linear) and 2a
    at 4,096 x 50 (the rho = 0.9 Gaussian's oracle metric, L 16,
    constant)."""
    import chip_smoke as cs
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device(DEVICE)
    const, linear = ft.SCHEDULE_IDS["constant"], ft.SCHEDULE_IDS["linear"]
    cases = {}

    def k2(name, family, n, dim, L, sched, step, invm=None, l_inv=None):
        t = get_target(family, dim=dim)
        q = t.init_sampler(g, n) if t.init_sampler is not None else (
            torch.randn((n, dim), generator=g, device=dev) * 0.5)
        if family == "log_gamma":
            q = torch.rand((n, dim), generator=g, device=dev) * 2.0 + 0.3
        q = q.float().contiguous()
        lp, grad = (x.float().contiguous() for x in t.value_and_grad_fn(q))
        args = (t.value_and_grad_fn.kernel_info, L, sched, cs.MULTI_T, q, lp, grad,
                ft.kernel_scalars(step, 0.1, cs.STEEPNESS, dev),
                torch.ones(dim, device=dev) if invm is None else invm)
        cases[name] = (lambda: ft.grahmc_multistep_kernel(*args, key=key, call=0, l_inv=l_inv),
                       n * L * cs.MULTI_T)

    for family, step in (("multimodal_funnel_2d", 0.3), ("concentric_l1_2d", 0.1),
                         ("nested_l1_2d", 0.1)):
        k2(f"k2 [6h] 1,024 x 2 {family}", family, cs.RAHMC_CHAINS, 2, 16, const, step)
    for family in SWEEP:
        k2(f"k2 sweep 1,024 x 10 {family}", family, cs.SWEEP_CHAINS, cs.SWEEP_DIM, cs.SWEEP_L,
           const, 0.1 if family == "log_gamma" else 0.3)
    a = torch.randn((10, 10), generator=g, device=dev, dtype=torch.float64)
    invm, l_inv = ft.prepare_dense_metric(0.02 * (a @ a.T / 10) + 0.02 * torch.eye(
        10, device=dev, dtype=torch.float64))
    k2("2a Rosenbrock 1,024 x 10 L 64", "rosenbrock", cs.RAHMC_CHAINS, 10, 64, linear, 0.02,
       invm, l_inv)
    c = get_target("correlated_gaussian", dim=50, correlation=0.9)
    invm, l_inv = ft.prepare_dense_metric(c.true_cov.to(dev, torch.float64))
    cq = (torch.randn((cs.MULTI_CHAINS, 50), generator=g, device=dev) * 0.5).contiguous()
    clp, cgrad = (x.float().contiguous() for x in c.value_and_grad_fn(cq))
    a2a = (c.value_and_grad_fn.kernel_info, cs.NUM_STEPS, const, cs.MULTI_T, cq, clp, cgrad,
           ft.kernel_scalars(0.3, 0.1, cs.STEEPNESS, dev), invm)
    cases["2a 4,096 x 50 T 8"] = (lambda: ft.grahmc_multistep_kernel(*a2a, key=key, call=0,
                                                                       l_inv=l_inv),
                                  cs.MULTI_CHAINS * cs.NUM_STEPS * cs.MULTI_T)
    return cases


def worker_time(torch, has, reps, pick, burst=10):
    cases = timed_cases(torch, has, pick)
    ms, per = {}, {}
    for name, (run, substeps) in cases.items():
        run()
        ms[name] = [_event_ms(torch, run, burst) for _ in range(reps)]
        per[name] = substeps
    print("TIMES " + json.dumps({"ms": ms, "substeps": per}))


def worker_smc(torch):
    """chip_smoke.py's [5i] and [5j] on this tree's kernels, and the device
    share of one 8-move run of the pair (one profiled run)."""
    import chip_smoke as cs
    from mcmc_tpu_torch import samplers, targets
    dev = torch.device(DEVICE)
    row = cs.phase_smc_row(torch, targets, samplers, dev)
    pair = cs.phase_smc_move_pair(torch, targets, samplers, dev)
    t = targets.get_target("gaussian_mixture", dim=cs.SMC_DIM)
    kw = dict(cs._smc_kw(t), n_particles=cs.MOVE_P, num_steps=cs.MOVE_L, move_steps=8,
              betas=torch.linspace(0.08, 1.0, cs.MOVE_RUNGS, dtype=torch.float64))
    busy = cs.device_busy_seconds(
        torch, lambda: samplers.smc_run(cs._gen(torch, dev, 80), t.log_prob_fn, **kw))
    print("SMC_RESULT " + json.dumps({"row_rate": row["rate"], "row_wall": row["wall"],
                                      "row_busy": row["busy"], "pair_rate": pair["rate"],
                                      "pair_wall_8": pair["walls"][8], "pair_busy_8": busy}))


def worker(args):
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))   # chip_smoke.py's inputs
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    csrc = root / "mcmc_tpu_torch" / "csrc"
    has = {"trajectory": (csrc / "fused_trajectory.cu").exists(),
           "bridged": (csrc / "fused_trajectory_bridged.cu").exists(),
           "rwmh": (csrc / "fused_rwmh.cu").exists(), "nuts": (csrc / "fused_nuts.cu").exists()}
    if args.worker == "build":
        from mcmc_tpu_torch.ops import _cuda
        for old in _cuda.BUILD_DIR.glob(f"libmcmc_kernels_{_cuda._digest()}.so"):
            old.unlink()      # built before (a test run): build again for the ptxas log
        lib = _cuda.load_library()
        Path(args.save).write_text(lib.build_log)
        print(f"built {lib.path.name} in {lib.build_seconds:.1f} s")
    elif args.worker == "outputs":
        t0 = time.perf_counter()
        out = outputs(torch, args.outputs.split(","), has)
        torch.cuda.synchronize()
        Path(args.save).write_text(json.dumps(out))
        print(f"{len(out)} outputs' digests saved in {time.perf_counter() - t0:.1f} s")
    elif args.worker == "smc":
        worker_smc(torch)
    else:
        worker_time(torch, has, args.reps, re.compile(args.cases))


def run_worker(kind, root, save="", reps=10, cases="."):
    cmd = [sys.executable, __file__, "--worker", kind, "--root", str(root), "--save", str(save),
           "--reps", str(reps), "--cases", cases]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    if proc.returncode:
        sys.exit(f"{kind} worker in {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return proc.stdout


def make_patched(tree, dst, names, keep=None):
    """A copy of tree's mcmc_tpu_torch under dst, cut to the sources `keep`
    names, by default those the edits of `names` (PATCHES) touch
    (RWMH_SOURCES for fused_rwmh.cu's, BRIDGED_SOURCES for
    fused_trajectory_bridged.cu's, TRAJECTORY_SOURCES for the others'), with
    those edits applied."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(Path(tree) / "mcmc_tpu_torch", dst / "mcmc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = dst / "mcmc_tpu_torch" / "csrc"
    if keep is None:
        keep = set()
        for patch in names:
            for name, _, _ in PATCHES[patch]:
                keep |= set(next((srcs for srcs in (RWMH_SOURCES, BRIDGED_SOURCES)
                                  if name in srcs), TRAJECTORY_SOURCES))
    for src in csrc.glob("*.cu"):
        if src.name not in keep:
            src.unlink()
    cuda = dst / "mcmc_tpu_torch" / "ops" / "_cuda.py"
    text = cuda.read_text()
    old, new = ("        fn = getattr(lib, name)\n",
                "        fn = getattr(lib, name, None)\n        if fn is None:\n            continue\n")
    if text.count(new) != 1:        # not a copy of a cut tree already
        if text.count(old) != 1:
            sys.exit(f"_cuda.py: {old!r} is not once there")
        cuda.write_text(text.replace(old, new))
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
    """The parent's kernel-1, 1b, 1c or 2 instance name with G = 32 added,
    as the tree names its warp-per-chain instances (1c's since its lane
    groups; a name that has G already is left as it is)."""
    return re.sub(r"(grahmc_(?:step|scaled|multistep|bridged)_kernelILi\d+ELi\d+ELb[01]E)E",
                  r"\1Li32EE", name)


def spill_bytes(line):
    """(spill stores, spill loads) in bytes of a ptxas_lines entry."""
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    return (int(m.group(1)), int(m.group(2))) if m else (0, 0)


def compare_bridged_spills(lines):
    """Each tree's 1c instances that spill more than the parent's instance
    of the same name (or spill where it did not), and their count."""
    old = {with_lanes(k): v for k, v in lines["parent"].items() if "bridged" in k}
    for label, got in lines.items():
        if label == "parent":
            continue
        mine = {k: v for k, v in got.items() if "grahmc_bridged_kernel" in k}
        worse = []
        for k, v in sorted(mine.items()):
            # a lane-group instance against the parent's warp instance
            base = spill_bytes(old.get(re.sub(r"(Lb[01]E)Li\d+E", r"\1Li32E", k), ""))
            if spill_bytes(v) > base and spill_bytes(v) != (0, 0):
                worse.append((k, v, base))
        spilling = sum(spill_bytes(v) != (0, 0) for v in mine.values())
        print(f"[ptxas] {label}: {len(mine)} 1c instances, {spilling} spill, {len(worse)} spill "
              f"more than the parent's", flush=True)
        for k, v, base in worse:
            print(f"  {k}: {v} (parent {base[0]}/{base[1]} bytes)")


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


def sass_counts(so):
    """{kernel 3's or kernel 2's instance's mangled name: (SASS
    instructions in all, in its largest loop, in the largest loop inside
    that one)} from `cuobjdump -sass` of the library `so`: a loop is the
    span of a backward branch; the largest is the transition loop over t
    (Philox's rounds and the coordinate loops are unrolled), the one inside
    it kernel 2's substep loop. Branch targets are read as addresses or as
    labels."""
    text = sass_text(so)
    out = {}

    def close(name, ins, labels):
        if name and ("rwmh" in name or "multistep" in name):
            loops = []
            for at, target in ins:
                to = labels.get(target) if target and not target.startswith("0x") else (
                    int(target, 16) if target else None)
                if to is not None and to < at:
                    loops.append((to, at))
            span = lambda lo, hi: (hi - lo) // 16 + 1   # noqa: E731
            outer = max(loops, key=lambda x: span(*x), default=(0, -16))
            inner = [x for x in loops if x != outer and outer[0] <= x[0] and x[1] <= outer[1]]
            out[name] = (len(ins), span(*outer),
                         max((span(*x) for x in inner), default=0))

    name, ins, labels, pending = None, [], {}, []
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            close(name, ins, labels)
            name, ins, labels, pending = head.group(1), [], {}, []
            continue
        label = re.match(r"\s*\.?(L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name:
            at = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = at
            pending = []
            jump = re.search(r"\bBRA(?:\.\w+)*\s+(?:`\(\.?(L_x_\d+)\)|(0x[0-9a-f]+))",
                             m.group(2))
            ins.append((at, (jump.group(1) or jump.group(2)) if jump else None))
    close(name, ins, labels)
    return out


def sass_text(so):
    tool = Path(_cuda_home()) / "bin" / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout


def dump_sass(so, pattern, dst):
    """Write the SASS of every function whose mangled name `pattern` finds to
    dst/<name>.sass."""
    dst.mkdir(parents=True, exist_ok=True)
    name, lines = None, []
    for line in sass_text(so).splitlines() + ["Function : end"]:
        head = re.search(r"Function : (\S+)", line)
        if head:
            if name and re.search(pattern, name):
                (dst / f"{name}.sass").write_text("\n".join(lines) + "\n")
            name, lines = head.group(1), []
        lines.append(line)


def _cuda_home():
    from shutil import which
    nvcc = which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return str(Path(nvcc).resolve().parents[1])


def sm_clocks():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


# kernel 2's instances the timed cases run: the sweep's five families and
# [6h]'s three at K = 1, Rosenbrock's 2a, the funnel at K = 2 (warp and 16
# lanes), 2a on the correlated Gaussian at K = 2
K2_TIMED = (r"grahmc_multistep_kernelILi(?:(?:5|6|7|8|9|11|12|13)ELi1ELb0|10ELi1ELb1|"
            r"1ELi2ELb0|2ELi2ELb1)ELi(?:16|32)EE")


def print_sass_code(trees, lines, sass_dir=None, pattern=None):
    """Step 2's SASS part: each tree's kernel-3 instances and kernel 2's
    timed ones (K2_TIMED), their SASS counts and ptxas lines; with
    `pattern`, the SASS of the functions it finds under sass_dir/<tree>/."""
    for label, root in trees.items():
        libs = sorted((Path(root) / "mcmc_tpu_torch" / "_build").glob("libmcmc_kernels_*.so"))
        csrc = Path(root) / "mcmc_tpu_torch" / "csrc"
        if not libs:
            continue
        try:
            counts = {with_lanes(k): v for k, v in sass_counts(libs[-1]).items()}
            if pattern:
                dump_sass(libs[-1], pattern, sass_dir / label)
        except (OSError, subprocess.CalledProcessError) as err:
            print(f"[sass] {label}: cuobjdump failed: {err}", flush=True)
            continue
        ptx = {with_lanes(k): v for k, v in lines[label].items()}
        if (csrc / "fused_rwmh.cu").exists():
            print(f"[sass] {label}: kernel 3's instances, SASS instructions in all / in the "
                  f"transition loop; ptxas", flush=True)
            for k, (total, span, _) in sorted(counts.items()):
                if "rwmh" in k:
                    print(f"  {k}: {total} / {span}; {ptx.get(k, '?')}")
        if (csrc / "fused_trajectory.cu").exists():
            print(f"[sass] {label}: kernel 2's timed instances, SASS instructions in all / in "
                  f"the transition loop / in the substep loop (static spans); ptxas", flush=True)
            for k, (total, span, inner) in sorted(counts.items()):
                if re.search(K2_TIMED, k):
                    print(f"  {k}: {total} / {span} / {inner}; {ptx.get(k, '?')}")


def compare_outputs(trees, work, groups):
    """Every tree's outputs of `groups` against the parent's; a variant
    (not "tree") computes only those of VARIANT_GROUPS among them."""
    t0 = time.perf_counter()
    labels = list(trees)
    for i in range(0, len(labels), OUTPUT_WORKERS):
        procs = {label: subprocess.Popen(
            [sys.executable, __file__, "--worker", "outputs", "--root", str(trees[label]),
             "--save", str(work / f"outputs_{label}.json"), "--outputs",
             groups if label in ("parent", "tree") else
             ",".join(x for x in groups.split(",") if x in VARIANT_GROUPS) or "none"],
            stdout=subprocess.PIPE,
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


def smc_in_turns(trees, out):
    """[5i] and [5j] in the parent and the tree, in turns (parent, tree,
    tree, parent): each run's rates, walls and device shares."""
    runs = {"parent": [], "tree": []}
    for label in ("parent", "tree", "tree", "parent"):
        text = run_worker("smc", trees[label])
        got = json.loads(next(line for line in text.splitlines()
                              if line.startswith("SMC_RESULT "))[len("SMC_RESULT "):])
        runs[label].append(got)
        print(f"[smc] {label}: " + ", ".join(f"{k} {v:.6g}" for k, v in got.items()), flush=True)
    for label, rs in runs.items():
        print(f"[smc] {label}, both turns: [5i] smc_particle_leapfrogs_per_sec "
              f"{[round(r['row_rate']) for r in rs]}, busy "
              f"{[round(r['row_busy'] / r['row_wall'], 4) for r in rs]}; [5j] "
              f"smc_move_dominated_leapfrogs_per_sec {[round(r['pair_rate']) for r in rs]}, "
              f"busy {[round(r['pair_busy_8'] / r['pair_wall_8'], 4) for r in rs]}", flush=True)
    (out / "smc.json").write_text(json.dumps(runs))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--tree", default=".")
    ap.add_argument("--out", default="_archive/step_out")
    ap.add_argument("--work", default="_archive/step")
    ap.add_argument("--patched", action="append", default=[], help="+".join(PATCHES))
    ap.add_argument("--probe", action="append", default=[], help="PATCHES on the parent")
    ap.add_argument("--other", action="append", default=[],
                    help="LABEL=DIR: another tree's trajectory kernels, unpatched")
    ap.add_argument("--cases", default=".", help="a regex of the timed cases to run")
    ap.add_argument("--outputs", default=",".join(OUTPUT_GROUPS),
                    help="the output groups to compare: " + ",".join(OUTPUT_GROUPS))
    ap.add_argument("--sass", default="", help="a regex of the functions whose SASS is "
                                                "written under --out/sass/<tree>/")
    ap.add_argument("--skip-timing", action="store_true")
    ap.add_argument("--skip-sass", action="store_true", help="leave out step 2's SASS part")
    ap.add_argument("--keep", default="", help="SOURCE[,SOURCE]: the sources every tree "
                                               "keeps (default: all in the parent and the "
                                               "tree, those its edits touch in a variant)")
    ap.add_argument("--build-trees", type=int, default=BUILD_TREES,
                    help="trees built at once")
    ap.add_argument("--smc", action="store_true",
                    help="the SMC row [5i] and the move-dominated pair [5j], parent and tree "
                         "in turns")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--worker", choices=("build", "outputs", "time", "smc"))
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
    print(f"SM clock, max SM clock: {sm_clocks()}", flush=True)
    trees = {"parent": Path(args.parent).resolve(), "tree": Path(args.tree).resolve()}
    keep = set(args.keep.split(",")) if args.keep else None
    if keep:
        trees = {label: make_patched(root, work / f"{label}_kept", [], keep=keep)
                 for label, root in trees.items()}
    for base, names in (("tree", args.patched), ("parent", args.probe)):
        for label in names:
            if not set(label.split("+")) <= set(PATCHES):
                sys.exit(f"{label}: not among {sorted(PATCHES)}")
            name = label if base == "tree" else f"parent+{label}"
            trees[name] = make_patched(trees[base], work / name.replace("+", "_"),
                                       label.split("+"), keep=keep)
    for other in args.other:
        label, root = other.split("=", 1)
        trees[label] = make_patched(Path(root).resolve(), work / label, [],
                                    keep=set(TRAJECTORY_SOURCES))
    t0 = time.perf_counter()
    procs = {}
    for label, root in list(trees.items()):
        while sum(p.poll() is None for p in procs.values()) >= args.build_trees:
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
                         if re.search(r"grahmc_(?:step|scaled|multistep|bridged)_kernelI.*"
                                      r"Li(4|8|16)EE", k))
        print(f"[ptxas] {label}: {len(grouped)} lane-group instances of kernels 1, 1b, 1c "
              f"and 2:")
        for k, v in grouped:
            print(f"  {k}: {v}")
    compare_bridged_spills(lines)
    if not args.skip_sass:
        print_sass_code(trees, lines, out / "sass", args.sass)
    differ = compare_outputs(trees, work, args.outputs)
    if args.smc:
        smc_in_turns(trees, out)
    if args.skip_timing:
        return 1 if differ else 0

    results = {label: {} for label in trees}
    substeps = {}
    order = list(trees)
    for label in order + order[::-1]:
        text = run_worker("time", trees[label], reps=args.reps, cases=args.cases)
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
    print(f"SM clock, max SM clock after the timings: {sm_clocks()}", flush=True)
    (out / "times.json").write_text(json.dumps({"card": smi, "times": results,
                                                "substeps": substeps}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
