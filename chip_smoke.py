#!/usr/bin/env python3
"""Drive the mcmc_tpu_torch main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--multistep-switch | --smc-repeat | --runner-cell | --chain-mesh]

Run from the repository root on a machine with a CUDA GPU and nvcc. It
builds the hand-written CUDA kernels from mcmc_tpu_torch/csrc, holds each
against its plain PyTorch version at its main-path shape, checks the
in-kernel Philox draws statistically (fused against eager), then runs
bench.py's GRAHMC, NUTS, NUTS-multinomial and RWMH rows, a dense-metric
NUTS row and a dense-warmup GRAHMC row on the port:

- GRAHMC: the 50-D Neal's funnel at 65,536 chains, L = 16 and the constant
  schedule, the step size tuned by dual averaging through the fused kernel,
  a timed 768-draw run, a 192-draw full-history run with chunked bulk ESS,
  and a 4,096-chain run through the multi-transition kernel (kernels 1, 2);
- persistent NUTS: the same funnel at 65,536 chains, the step size tuned by
  dual averaging through the persistent path, then 192 draws of 64 slots,
  timed, with the last rep's full-history bulk ESS (kernel 4, endpoint
  scheme); then the same run with the multinomial scheme (kernel 4a);
- dense-metric NUTS: the 50-D rho = 0.9 correlated Gaussian at 65,536
  chains with the oracle metric (its covariance), the step tuned as the
  NUTS row's, 192 draws of 64 slots with both schemes (kernels 4b and 4a
  with 4b), and at 4,096 chains the diagonal metric's ESS against it;
- RWMH: the 10-D standard normal at 65,536 chains, 16,384 draws, 32
  transitions per call (kernel 3);
- dense-warmup GRAHMC: the 50-D rho = 0.9 correlated Gaussian at 65,536
  chains, the library's windowed warmup learning a dense metric and the
  sequential ESJD tune of gamma (kernel 1a), then the GRAHMC row's timing
  and ESS protocol at the tuned step, gamma and metric (kernel 1a), and at
  4,096 chains a dense and a diagonal warmup each followed by a 256-draw
  multistep run (kernels 2a and 2);
- tempered GRAHMC (bench.py:581-634): the 10-D two-mode mixture, a 6-rung
  geometric ladder (beta_min 0.02) over 8,192 chains, L = 16, tanh friction,
  256 draws per run, each run continuing from the last one's replicas
  (kernel 1b, one launch per sweep); then the crossing check (4-D mixture,
  separation 10, 4,096 chains all started in the left mode: the ladder
  finds both modes, fused HMC through kernel 2 stays) and tune_ladder over
  the row's configuration;
- annealed SMC (bench.py:636-720): adaptive-schedule evidence runs on the
  10-D mixture at 32,768 particles, and the move-dominated pair at 65,536
  particles on a fixed 13-rung ladder with 2 and 8 moves (kernel 1c, one
  launch per move); two runs with one seed must agree bit for bit;
- config 5 (BASELINE.json configs[4]): the 100-D hierarchical logistic
  posterior (256 data rows) at 8,192 chains, the windowed warmup with its
  gamma tune (kernel 1d, the data-carrying form of kernel 1), a
  1,000-draw full-history GRAHMC run with its diagnostics (1d), a 4,096-chain
  run through the multistep dispatch (2b, block-tiled as 1d is), persistent
  NUTS (4c) and RWMH (3a) on the same posterior; GRAHMC's posterior means
  must agree with RWMH's, two kernels apart;
- ChEES (bench.py:527-579): the 20-D non-centered funnel at 2,048 chains,
  run_chees_warmup("hmc", 2,500 steps), then chees_run at the tuned step, T
  and metric, 8,192 jittered draws a run (kernel 1, one launch per draw at
  the draw's quantized level); the transformed draws' funnel moments;
- the ChEES slice's families (the non-centered funnel, the ill-conditioned
  Gaussian, Student-t, log-gamma and its unconstrained form) at the
  canonical matrix's cell size (dim 10, 1,024 chains, 10,000 draws) under
  GRAHMC (kernels 1, 2), RWMH (3) and persistent NUTS (4), held to their
  exact samplers' means; before the rows, every kernel and variant on
  them (and kernel 3 on the correlated Gaussian, kernels 3 and 4 on the
  mixture) against the plain versions at D = 10 and 50;
- Rosenbrock and the RAHMC paper's targets at the same cell size [5o]:
  the 10-D Rosenbrock under GRAHMC with the dense learned metric at L = 64
  (kernels 1a, 2a), RWMH (dual_averaging_tune_rwmh, kernel 3) and
  persistent NUTS (the persistent warmup's kernel-4 windows, kernel 4b), a
  20-D GRAHMC run whose means are held against the JAX package's shipped
  long-NUTS draws (read as data), and the bimodal funnel and the
  concentric and nested L1 shells under all three (kernels 1-4), gated
  where the JAX package passes through the same protocol
  (experiments/torch_rahmc_witness.py); every kernel on the four families
  against its plain version first [3g], and each (kernel, family) pair
  timed at its cell's shape [6h];
- classic NUTS (samplers.nuts, eager) at 1,024 chains on the 10-D
  standard normal and Student-t [5p], and generate_rosenbrock_reference at
  a cut [5q];
- the research runner [5r]: run_benchmarks_torch.py's main() on the
  canonical matrix's non-centered-funnel cell (GRAHMC-constant, persistent
  NUTS and RWMH at dim 10, 1,024 chains, 2,500 warmup, 10,000 draws;
  kernels 1, 2, 3 and 4 through the runner's warmups, samplers,
  diagnostics, gates and Sliced-W2), GRAHMC's row held to the JAX
  package's recorded verdict; run again into the same directory (the
  warmup cache and resume: nothing runs, the files stay byte-equal) and
  with --no-warmup-cache into another (the same tuned steps and draws);
- the chain mesh [7] (mcmc_tpu_torch.parallel): the 11 surfaces of
  __graft_entry__.dryrun_multichip on two gloo ranks time-sharing the card
  (GRAHMC at the headline width, 65,536 x 50, L = 16; kernels 1, 1b, 1c,
  4, 4a and 4b each held bit for bit against a 1-rank run over the rank's
  chains; an eager run, the gathered diagnostics; the mesh warmup with its
  gamma tune, ChEES and the joint gamma tuner, and fixed-ladder SMC against
  their unsharded runs, held to the dryrun's bounds), then the GRAHMC
  surface on a 1-rank NCCL group; its launches are the ranks' counts.

--multistep-switch adds a measurement that gates nothing: grahmc_run at
1,024 and 4,096 chains through the multi-transition dispatch (T = 8)
against the single-transition one (T = 1), with the learned dense metric
and its diagonal.

    python3 chip_smoke.py --smc-repeat

runs only the build and the SMC repeat probe: the resampling CDF summed by
torch.cumsum and by samplers.smc.prefix_sum, each repeated on one input,
and the SMC row's warm run repeated with each, printing log Z's bits so
that two processes can be compared. It exits 0 whatever it finds.

    python3 chip_smoke.py --runner-cell

runs only the build and [5r], with its launch counts.

    python3 chip_smoke.py --chain-mesh

runs only the build and [7], with its launch counts.

Every phase passes or raises; there is no CPU path. After the rows every
kernel is timed at the shapes the paths ran it at ([6]-[6i]; kernel 1 and
1a also at the dense-warmup row's 4,096-chain warmups, kernels 1-4 at the
family sweep's 1,024 x 10), and [8] prints, largest first, each (kernel,
shape)'s launches x (time - bound), with 1a's, 4b's and 3a's yardsticks
(their products as torch.matmul calls), 1d's and 4c's time per gradient
evaluation beside the eager value_and_grad, and the tiled 2b's beside 1d's.
The last two lines are a JSON object describing each kernel and kernel
variant at its main shape, each split row (ChEES, the 4,096-chain
warmups) and each (kernel, family) pair of the sweep's and [5o]'s cells (its launches at that shape -- a kernel's launches at the
shapes left untimed, the crossing check's, the ladder tune's, the SMC
row's and the dense NUTS row's 4,096-chain check, stay in its main row --
error against its plain version, time, the plain version's time and the
least time the card could take) and {"ok": true, "device": {...}}.
"""

import json
import math
import os
import re
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
# NUTS-multinomial row (bench.py:453-493): the NUTS row's step, init and sizes
# dense-metric NUTS row: 50-D rho = 0.9 correlated Gaussian, oracle metric
DENSE_RHO = 0.9
DENSE_PARITY_STEP = 0.5      # whitened N(0, I_50): near its tuned step
DENSE_CHECK_CHAINS = 4096    # the oracle-vs-diagonal ESS check
DENSE_ESS_RATIO = 3.0        # tests/test_dense_metric.py:77
# dense-warmup GRAHMC row: the same target, the metric learned by the
# library's default schedule (500 + [25, 50, 100, 200, 500, 1000] + 125,
# update_freq 100) and the default gamma grid and tune (max_iter_step 1000,
# 150 ESJD transitions per gamma)
WARMUP_STEPS = 2500
WARMUP_TRANSITIONS = 2700        # masked steps pad the 25- and 50-step windows
TUNE_TRANSITIONS = 7 * (1000 + 150)
WARMUP_METRIC_TOL = 0.05         # max |M^{-1} - Sigma|; shrinkage alone 0.0045
WARMUP_COV_TOL = 0.1
# multinomial variance check: 4-D N(0, I) from exact starts, both backends
VAR_DIM = 4
VAR_CHAINS = 65536
VAR_STEP = 0.5
VAR_SAMPLES = 16
VAR_DEPTH = 8
VAR_TOL = 0.02

# tempered row (bench.py:587-634)
TEMP_DIM = 10
TEMP_K = 6
TEMP_CHAINS = 8192
TEMP_L = 16
TEMP_DRAWS = 256
TEMP_STEP = 0.5
TEMP_BETA_MIN = 0.02
TEMP_GAMMA = 0.1
TEMP_STEEP = 5.0
TEMP_COLLECT = 64
TEMP_REPS = 4                # after two warm runs, each continuing the ladder
# crossing check (tests/test_tempered.py:111-137) at 4,096 chains
CROSS_DIM = 4
CROSS_SEP = 10.0
CROSS_CHAINS = 4096
CROSS_K = 6
CROSS_BETA_MIN = 0.01
CROSS_STEP = 0.3
CROSS_DRAWS = 800
CROSS_BURN = 200
# ladder tune (tests/test_ladder.py:141-170) on the tempered row's configuration
LADDER_ROUNDS = 8
LADDER_DRAWS = 64
# SMC row (bench.py:643-678) and its move-dominated pair (bench.py:686-720)
SMC_DIM = 10
SMC_P = 32768
SMC_STEP = 0.4
SMC_L = 8
SMC_MOVES = 2
SMC_BASE_SCALE = 6.0
SMC_REPS = 4                 # after one warm run
MOVE_P = 65536
MOVE_L = 16
MOVE_RUNGS = 13              # the fixed ladder linspace(0.08, 1, 13)
MOVE_REPS = 3                # after one warm run; min of the reps
# config 5 (BASELINE.json configs[4], BASELINE.md:91): the 100-D hierarchical
# logistic posterior at the factory's defaults, 8,192 chains; the windowed
# warmup (diagonal metric, tanh, L = 16, the JAX defaults otherwise) with its
# gamma tune, then GRAHMC, NUTS and RWMH on it (kernels 1d, 2b, 4c, 3a)
HIER_DIM = 100
HIER_N_DATA = 256
HIER_CHAINS = 8192
HIER_L = 16
HIER_DRAWS = 1000            # the full-history GRAHMC run (3.3 GB)
HIER_MULTI_CHAINS = 4096     # grahmc_run takes kernel 2b here
HIER_MULTI_DRAWS = 256
HIER_NUTS_REPS = 1           # timed reps after the warm-up run
HIER_RWMH_DRAWS = 2048
# RWMH's reference run for GRAHMC's means: HIER_RWMH_KEEP draws, one every
# RWMH_T transitions (one kernel 3a call), every chain kept (3.3 GB)
HIER_RWMH_KEEP = 1024
HIER_ACCEPT_TOL = 0.07
HIER_RHAT_MAX = 1.05
HIER_ESS_MIN = 400.0
HIER_MCSE_Z = 5.0            # GRAHMC and RWMH means within this many combined MCSE
# the ChEES row (bench.py:527-579), uncut: 20-D non-centered funnel, 2,048
# chains from N(0, 0.5^2), run_chees_warmup("hmc", 2,500 steps), then
# chees_run at the tuned step, T and metric: a warm call and 4 timed reps of
# 8,192 draws keeping 64 chains, at halton_offset 16,384 + 8,192 rep
CHEES_DIM = 20
CHEES_CHAINS = 2048
CHEES_WARMUP = 2500
CHEES_DRAWS = 8192
CHEES_COLLECT = 64
CHEES_REPS = 4
CHEES_ACCEPT = 0.651         # run_chees_warmup's target
# the families of the ChEES slice and the gap pairs it closes, against the
# plain versions at D = 10 (K = 1) and D = 50 (K = 2), 16,384 chains [3g]
NEW_FAMILIES = ("neals_funnel_noncentered", "ill_conditioned_gaussian", "student_t",
                "log_gamma", "log_gamma_unconstrained")
FAMILY_KERNELS = {f: ("grahmc", "rwmh", "nuts") for f in NEW_FAMILIES}
FAMILY_KERNELS.update({"correlated_gaussian": ("rwmh",), "gaussian_mixture": ("rwmh", "nuts")})
FAMILY_DIMS = (10, 50)
FAMILY_CHAINS = 16384
FAMILY_L = 16
FAMILY_STEP = {"neals_funnel_noncentered": 0.3, "ill_conditioned_gaussian": 0.3,
               "student_t": 0.3, "log_gamma": 0.1, "log_gamma_unconstrained": 0.2,
               "correlated_gaussian": 0.1, "gaussian_mixture": 0.3}
# Rosenbrock and the RAHMC paper's families, in every kernel and
# variant [3g]: at the D of each of their [5o] cells (the shapes the main
# path gives the kernels; a (kernel, family) pair's max |err| in the
# kernels line is read at its timed cell's D, phase_timing_rahmc's) and at
# D = 10 and 50 (the L1 shells' centres, Rosenbrock's neighbour exchange
# within a lane and across registers); the bimodal funnel at its own D = 2
RAHMC_FAMILIES = ("rosenbrock", "multimodal_funnel_2d", "concentric_l1_balls", "nested_l1_balls")
FAMILY_KERNELS.update({f: ("grahmc", "rwmh", "nuts") for f in RAHMC_FAMILIES})
RAHMC_PARITY_DIMS = {"rosenbrock": (10, 20, 50), "multimodal_funnel_2d": (2,),
                     "concentric_l1_balls": (2, 10, 50), "nested_l1_balls": (2, 10, 50)}
FAMILY_STEP.update({"rosenbrock": 0.02, "multimodal_funnel_2d": 0.3,
                    "concentric_l1_balls": 0.1, "nested_l1_balls": 0.1})
# families whose geometry amplifies rounding (near log_gamma's boundary the
# gradient (shape - 1) / x kicks the momentum, past |x| = sqrt(df)
# Student-t's log-density is convex, the mixture's barrier is a concave
# ridge: there the leapfrog separates nearby trajectories), each with its
# [3g] bounds as shares of the chains: kernels 1, 1a-1c, 2 and 2a's
# proposals drifted (one trajectory diverging alone counts here), their
# proposals diverged apart (|delta H| >= 1000 in both, rejected by both),
# and kernel 4's trajectories in flight drifted. Set at ~4x the largest count this script read on an H100 at
# 16,384 chains: log_gamma 8, 70 and 145 chains, Student-t 2, 0 and 0, the
# mixture (kernels 3 and 4 only) 28 in flight. Any other family: 0, 0 and
# SPLIT_MAX.
FAMILY_DRIFT = {"log_gamma": (2e-3, 2e-2, 3.6e-2), "student_t": (5e-4, 0.0, SPLIT_MAX),
                "gaussian_mixture": (0.0, 0.0, 7e-3),
                # the bimodal funnel's neck: 3 of 16,384 kernel-1
                # proposals diverged in both versions (0 drifted, 0 in flight);
                # the other new families read 0 everywhere
                "multimodal_funnel_2d": (0.0, 8e-4, SPLIT_MAX)}
# run_benchmarks_torch.py on the canonical matrix's non-centered-funnel cell
# (experiments/run_native_rescue_arm.sh:29 and :54's budgets; the L grid
# pinned at 16, the L the JAX package's row took from the default grid) [5r]
RUNNER_ARGS = ("--targets", "neals_funnel_noncentered", "--samplers", "grahmc", "nuts", "rwmh",
               "--schedules", "constant", "--dim", "10", "--n-chains", "1024", "--num-warmup",
               "2500", "--num-samples", "10000", "--num-steps-grid", "16",
               "--mass-matrix-mode", "mass", "--seed", "42", "--mesh", "off")
RUNNER_PATH = "runner cell"
RUNNER_REFERENCE = "results_full_matrix_native/benchmark_results.json"   # read as data
RUNNER_TARGET = "NealsFunnelNonCentered10D"
RUNNER_TUNE_T = 4            # the RWMH tuner's T: the largest dividing its 100 transitions
RUNNER_TUNE_CHUNK = 25       # DA iterations a chunk of dual_averaging_tune_rwmh
# the family sweep at the canonical matrix's cell size
# (results_full_matrix_native/README.md: dim 10, 1,024 chains, 2,500 warmup,
# 10,000 draws) [5n]
SWEEP_DIM = 10
SWEEP_CHAINS = 1024
SWEEP_DRAWS = 10000
SWEEP_L = 16
SWEEP_MULTI_T = 8            # grahmc_run's multistep T at 10,000 draws
SWEEP_RWMH_T = 16            # rwmh_run's T at 10,000 draws
SWEEP_RWMH_TUNE = 100        # DA iterations of 32 RWMH transitions (one kernel 3 call)
SWEEP_RWMH_ACCEPT = 0.234    # the JAX package's TARGET_ACCEPT_RWMH
SWEEP_REF_DRAWS = 1_000_000  # exact-sampler draws the means are held against
SWEEP_RHAT_MAX = 1.05
SWEEP_MCSE_Z = 5.0
SWEEP_TAIL = 1e-3            # exact share outside the reference draws' central 99.9%
# cells where the reference itself misses the gates, each with what stays
# gated. The constrained log_gamma under gradient samplers diverges at its
# support boundary (README above): finite draws only, the divergence rate
# printed.
SWEEP_FINITE_ONLY = {("log_gamma", "grahmc"), ("log_gamma", "nuts")}
# Persistent NUTS on log_gamma's unconstrained form: the reference's own
# rescue arm reads z 10.37 (learned metric) and 7.92 (identity) in this
# cell (README above, the "LogGamma / nuts" rows, log-reparam + multinomial
# NUTS; the window-emission bias, BASELINE.md bias audit #4): R-hat gated,
# and the means' z within 1.5x of 10.37.
SWEEP_Z_MAX = {("log_gamma_unconstrained", "nuts"): 1.5 * 10.37}
# Persistent NUTS on Student-t(3): the reference's canonical cell fails
# (results_full_matrix/benchmark_results.csv, nuts / StudentT10D_df3.0 /
# learned metric: R-hat 1.0276, quality_pass False), and the JAX package's
# machine leaves chains in the tails for thousands of draws as the port's
# does (experiments/torch_student_t_nuts_witness.py). A trapped chain
# moves its own mean, which the spread of the 1,024 chains' means sees and
# sd / sqrt(bulk ESS) (printed) does not: R-hat gated, and the means' z by
# the chains' spread alone.
SWEEP_CHAINS_Z = {("student_t", "nuts")}

# Rosenbrock and the RAHMC paper's cells [5o]: the canonical matrix's
# protocol (results_full_matrix_native/README.md: 1,024 chains, the 2,500-step
# windowed warmup, 10,000 draws) through the library's entry points:
# GRAHMC (run_adaptive_warmup("grahmc", fused): kernel 1, or 1a with the
# dense learned metric; grahmc_run: kernel 2 or 2a, T = 8), RWMH
# (dual_averaging_tune_rwmh: kernel 3, 100 transitions a DA iteration, four
# calls of T = 4; rwmh_run from the initial positions, as the JAX runner
# does: T = 16) and persistent NUTS (run_adaptive_warmup("nuts",
# "persistent"), depth 15: one kernel-4 window per warmup step;
# nuts_run_persistent, 64 slots a draw, depth 10). Each cell: (get_target
# name, dim, samplers, learned metric, friction schedule, L); Rosenbrock's
# GRAHMC arm is the matrix's passing one (linear, L = 64, dense).
RAHMC_CELLS = {
    "rosenbrock10": ("rosenbrock", 10, ("grahmc", "rwmh", "nuts"), "dense", "linear", 64),
    "rosenbrock20": ("rosenbrock", 20, ("grahmc",), "dense", "linear", 64),
    "multimodal": ("multimodal_funnel_2d", 2, ("grahmc", "rwmh", "nuts"), True, "constant", 16),
    "concentric": ("concentric_l1_2d", 2, ("grahmc", "rwmh", "nuts"), True, "constant", 16),
    "nested": ("nested_l1_2d", 2, ("grahmc", "rwmh", "nuts"), True, "constant", 16),
}
RAHMC_CHAINS = 1024
RAHMC_DRAWS = 10000
RAHMC_RWMH_T = 16            # rwmh_run's T at 10,000 draws
RAHMC_TUNE_T = 4             # the RWMH tuner's T: the largest dividing its 100 transitions
# The gates, where the witness (experiments/torch_rahmc_witness.py: the JAX
# package on the CPU through the same protocol at 64 chains x 2,000 draws)
# passes them with a margin for the card's 16x chains (R-hat <= 1.03, z <=
# 3): "rhat" R-hat <= 1.05, "z" every mean within 5 combined MCSE (both
# MCSEs) of the reference (10^6 exact draws for the bimodal funnel, 0 by
# symmetry for the L1 shells). Every other cell prints its readings: the
# witness reads R-hat 2.73 (RWMH) and 1.47 (NUTS) on the 10-D Rosenbrock
# (the canonical matrix's NUTS cell 1.374), R-hat 1.195 and z 22 for the
# 20-D GRAHMC run against the shipped long-NUTS draws, R-hat 1.06-1.34 on
# the funnel, the concentric RWMH and NUTS and every nested cell, and z 33
# for persistent NUTS on the funnel (its mode share 0.82, not 0.5).
RAHMC_GATES = {("rosenbrock10", "grahmc"): ("rhat",),
               ("multimodal", "grahmc"): ("z",), ("multimodal", "rwmh"): ("z",),
               ("concentric", "grahmc"): ("rhat", "z"), ("concentric", "rwmh"): ("z",),
               ("concentric", "nuts"): ("z",), ("nested", "grahmc"): ("z",),
               ("nested", "rwmh"): ("z",), ("nested", "nuts"): ("z",)}
ROSENBROCK_20D_REF = "mcmc_tpu/targets/reference_samples/rosenbrock_20d.npy"
# classic NUTS on the card [5p]: 1,024 chains, depth 10, a 150-step warmup
# (50 + 25 + 50 + 25, DA batches of 25) and 200 draws. The batch runs until
# its deepest tree ends, ~0.33 s a transition on Student-t on an H100, so
# the cut is short.
CLASSIC_DIM = 10
CLASSIC_CHAINS = 1024
CLASSIC_DEPTH = 10
CLASSIC_WARMUP = dict(exploration_steps=50, adaptation_windows=[25, 50], cooldown_steps=25,
                      update_freq=25)
CLASSIC_DRAWS = 200
# generate_rosenbrock_reference at a cut [5q]: dim 10, 32 chains, the
# classic warmup above, depth 10 (the function's default 12 took 0.43 s a
# transition), 1,024 draws thinned by 2 (32 per chain)
REF_DIM, REF_CHAINS, REF_DRAWS, REF_THIN, REF_DEPTH = 10, 32, 1024, 2, 10

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside the
# tensor cores; a kernel's bound is the larger of its bytes and its float
# operations over these.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# 1a's D x D products per transition: a velocity per substep, two kinetic
# energies and the unwhitening
DENSE_PRODUCTS = NUM_STEPS + 3
# device clock cycles (~2.5 ms) the device sleeps before a timed burst of
# 10 kernel calls, longer than the host takes to enqueue them
HOLD_CYCLES = 5_000_000

NUTS_SRC = ("mcmc_tpu_torch/csrc/nuts_window.cuh", "mcmc_tpu/ops/fused_nuts.py:139")
STEP_SRC = ("mcmc_tpu_torch/csrc/fused_trajectory.cu", "mcmc_tpu/ops/fused_trajectory.py:280")
MULTI_SRC = ("mcmc_tpu_torch/csrc/fused_trajectory.cu", "mcmc_tpu/ops/fused_trajectory.py:683")
# kernel 1's block-tiled variants 1a and 1d
TILED_SRC = ("mcmc_tpu_torch/csrc/tiled_step.cuh", "mcmc_tpu/ops/fused_trajectory.py:280")
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "grahmc_step_kernel": STEP_SRC,                     # diagonal
    "grahmc_step_kernel[dense]": TILED_SRC,
    "grahmc_multistep_kernel": MULTI_SRC,
    "grahmc_multistep_kernel[dense]": MULTI_SRC,
    "rwmh_multistep_kernel": ("mcmc_tpu_torch/csrc/fused_rwmh.cu",
                              "mcmc_tpu/ops/fused_rwmh.py:44"),
    "nuts_window_kernel": NUTS_SRC,                     # endpoint, diagonal
    "nuts_window_kernel[multinomial]": NUTS_SRC,
    "nuts_window_kernel[dense]": NUTS_SRC,
    "nuts_window_kernel[multinomial+dense]": NUTS_SRC,
    "grahmc_scaled_kernel": ("mcmc_tpu_torch/csrc/fused_trajectory_scaled.cu",
                             "mcmc_tpu/ops/fused_trajectory.py:333"),
    "grahmc_bridged_kernel": ("mcmc_tpu_torch/csrc/fused_trajectory_bridged.cu",
                              "mcmc_tpu/ops/fused_trajectory.py:344"),
    # the data-carrying forms on config 5's posterior
    "grahmc_step_kernel[data]": ("mcmc_tpu_torch/csrc/tiled_step.cuh",
                                 "mcmc_tpu/ops/fused_trajectory.py:300"),         # 1d
    "grahmc_multistep_kernel[data]": ("mcmc_tpu_torch/csrc/tiled_step.cuh",
                                      "mcmc_tpu/ops/fused_trajectory.py:701"),    # 2b, tiled
    "rwmh_multistep_kernel[data]": ("mcmc_tpu_torch/csrc/fused_rwmh.cu",
                                    "mcmc_tpu/ops/fused_rwmh.py:52"),             # 3a
    "nuts_window_kernel[data]": ("mcmc_tpu_torch/csrc/nuts_window.cuh",
                                 "mcmc_tpu/ops/fused_nuts.py:569"),               # 4c
    "nuts_window_kernel[multinomial+data]": ("mcmc_tpu_torch/csrc/nuts_window.cuh",
                                             "mcmc_tpu/ops/fused_nuts.py:569"),   # 4a + 4c
    # kernel 1 on the ChEES row's non-centered funnel, one launch per draw
    # at the draw's jitter level (launches: the ChEES row's own)
    "grahmc_step_kernel (ChEES row)": STEP_SRC,
    # kernel 1 and 1a at the dense-warmup row's 4,096-chain warmups
    "grahmc_step_kernel (4,096 chains)": STEP_SRC,
    "grahmc_step_kernel[dense] (4,096 chains)": TILED_SRC,
}
# rows split from a kernel's main-shape row: entry -> (the kernel's entry,
# the path whose launches it takes, and their chains, None for every shape).
# The family sweep's and [5o]'s launches go to "kernel (family)" pairs
# (PAIR_PATHS); a row's launches are read from the counts by shape
# (ops/fused_trajectory.py:count_launch).
SPLITS = {"grahmc_step_kernel (ChEES row)": ("grahmc_step_kernel", "ChEES row", None),
          "grahmc_step_kernel (4,096 chains)": ("grahmc_step_kernel", "dense-warmup GRAHMC row",
                                                MULTI_CHAINS),
          "grahmc_step_kernel[dense] (4,096 chains)": ("grahmc_step_kernel[dense]",
                                                       "dense-warmup GRAHMC row",
                                                       MULTI_CHAINS)}
PAIR_PATHS = ("family sweep", RUNNER_PATH) + tuple(f"{cell} cell" for cell in RAHMC_CELLS)
# kernels 1, 2, 1b and 1c's variants (ops/fused_trajectory.py:variant_name),
# kernel 3's (ops/fused_rwmh.py) and kernel 4's (ops/fused_nuts.py:variant)
# -> the names above (1b's and 1c's dense variants, and the data-carrying
# forms of 1a, 1b, 1c, 2a and 4b, run on no main path: the card tests check
# them)
GRAHMC_NAMES = {"diagonal": "", "dense": "[dense]", "diagonal+data": "[data]",
                "dense+data": "[dense+data]"}
RWMH_NAMES = {"rwmh": "rwmh_multistep_kernel", "rwmh+data": "rwmh_multistep_kernel[data]"}
NUTS_NAMES = {"endpoint": "nuts_window_kernel",
              "multinomial": "nuts_window_kernel[multinomial]",
              "dense": "nuts_window_kernel[dense]",
              "multinomial+dense": "nuts_window_kernel[multinomial+dense]",
              "endpoint+data": "nuts_window_kernel[data]",
              "multinomial+data": "nuts_window_kernel[multinomial+data]",
              "dense+data": "nuts_window_kernel[dense+data]",
              "multinomial+dense+data": "nuts_window_kernel[multinomial+dense+data]"}


def say(msg=""):
    print(msg, flush=True)


def ptxas_summary(log):
    """One line per compiled kernel of nvcc's -Xptxas -v log: its mangled
    name (template arguments included), registers and spills."""
    name, spill = None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        source = re.match(r"\[(\S+\.cu)\] nvcc ([\d.]+ s)", line)
        if source:
            yield f"{source.group(1)} compiled in {source.group(2)}"
        elif entry:
            name, spill = entry.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used \d+ registers", line)
            yield f"{name}: {regs.group(0) if regs else line.strip()}; {spill}"
            name = None
        elif "error" in line:
            yield line.strip()


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# ---------------------------------------------------------------------------
# Phase 3: kernel against plain version
# ---------------------------------------------------------------------------

def _compare(label, torch, kern, plain, log_u, alive=None, potential=None,
             vs_plain=("q", "lp", "grad"), away_max=0.0, border_max=None, flags=False,
             drift_max=0.0, wild_max=None, dh_accepted_only=False):
    """One transition of a kernel against its plain version, on the chains
    in `alive` (default all). kern/plain: dicts (_fields) with "accept" and
    "delta_h" (C,), any of "q", "lp", "grad" (the new state) and optionally
    "prop_q", "prop_lp" (the proposal). Each phase picks its rule:
    - an accept may differ away from the MH borderline (|log u - min(0,
      log alpha)| >= 1e-4) on at most `away_max` of the chains, at it on at
      most `border_max` (None: any);
    - kept: the chains whose accepts agree and whose proposal q and lp lie
      within 1e-4 (absolute plus relative; equal counts, as two -inf lp off
      log_gamma's support). The others diverged apart where both
      trajectories diverged (|delta H| >= 1000 in both: a diverged
      trajectory is chaotic; each such chain must be rejected by both),
      else drifted (one trajectory diverging alone counts here). At most
      `drift_max` of the chains drifted and at most `wild_max` diverged
      apart; with wild_max None, drift_max bounds both together;
    - in step: kept chains and the rejected chains whose accepts agree (their
      new state is the old one). On those, the `vs_plain` fields of the
      new state within 1e-4 of the plain version's, and lp and grad within
      1e-4 of `potential` (the plain (lp, grad) function) at the kernel's q
      where it is given (near the mixture's barrier the gradient moves ~5x
      as fast as x0, so a q within 1e-4 may carry a gradient beyond it:
      [3e] holds lp and grad to the potential only);
    - delta H within 2e-3 on kept chains whose plain trajectory did not
      diverge (dh_accepted_only: on accepted ones; the multistep kernel
      writes no proposal, so a rejected chain's delta H belongs to a
      proposal unseen here, which may have drifted);
    - flags: the divergence flags (|delta H| < 1000) agree wherever the
      accepts do.
    Returns (max |err| of the new state against the plain version on the
    chains in step, the chains in step)."""
    acck, accp, dhp = kern["accept"], plain["accept"], plain["delta_h"]
    n = acck.numel()
    alive = torch.ones(n, dtype=torch.bool, device=acck.device) if alive is None else alive

    def close(a, b, tol=1e-4):
        ok = ((a - b).abs() <= tol + tol * b.abs()) | (a == b)
        return ok.all(dim=1) if ok.ndim == 2 else ok

    borderline = (log_u - torch.clamp(-dhp, max=0.0)).abs() < 1e-4
    differ = (acck != accp) & alive
    away, border = int((differ & ~borderline).sum()), int((differ & borderline).sum())
    same = alive & ~differ
    kept = same
    if "prop_q" in kern:
        kept = same & close(kern["prop_q"], plain["prop_q"]) & close(kern["prop_lp"],
                                                                     plain["prop_lp"])
    div_k, div_p = kern["delta_h"].abs() >= 1000.0, dhp.abs() >= 1000.0
    apart = same & ~kept
    wild_rows = apart & div_k & div_p
    drifted, wild = int((apart & ~wild_rows).sum()), int(wild_rows.sum())
    one_sided = int((apart & (div_k != div_p)).sum())
    require(not bool((wild_rows & acck).any()), f"{label}: a diverged trajectory was accepted")
    if flags:
        require(bool((div_k == div_p)[same].all()), f"{label}: divergence flags differ")
    in_step = kept | (same & ~acck)
    err, residual = 0.0, None
    for name in ("q", "lp", "grad"):
        if kern.get(name) is None:
            continue
        if name in vs_plain:
            require(bool(close(kern[name], plain[name])[in_step].all()),
                    f"{label}: {name} of the new state differs from the plain version's")
        if in_step.any():
            err = max(err, float((kern[name] - plain[name]).abs()[in_step].max()))
    if potential is not None:
        at_q = potential(kern["q"])
        require(bool((close(kern["lp"], at_q[0]) & close(kern["grad"], at_q[1]))[in_step].all()),
                f"{label}: lp or grad differs from the device function at the kernel's q")
        residual = max((float((a - b).abs()[in_step].max()) if in_step.any() else 0.0)
                       for a, b in ((kern["lp"], at_q[0]), (kern["grad"], at_q[1])))
    stable = kept & (dhp.abs() < 1000.0)
    seen = stable & acck if dh_accepted_only else stable
    require(bool(close(kern["delta_h"], dhp, 2e-3)[seen].all()),
            f"{label}: delta H differs beyond 2e-3")
    prop = ""
    if "prop_q" in kern:
        size = (float((kern["prop_q"] - plain["prop_q"]).abs()[apart & ~wild_rows].max())
                if drifted else 0.0)
        prop = (f"; proposal within 1e-4 on {int(kept.sum())} ({drifted} drifted, {one_sided} "
                f"of them with one trajectory diverged, max |dq| {size:.3g}; {wild} diverged "
                f"apart, rejected by both)")
    at = "" if residual is None else f" ({residual:.3g} with lp and grad at the kernel's q)"
    say(f"  {label}: accepts agree on {int(same.sum())}/{int(alive.sum())} (split {away} away "
        f"from the MH borderline, {border} at it){prop}; max |err| {err:.3g}{at}; divergent "
        f"{int((kept & ~stable).sum())}")
    require(away <= away_max * n, f"{label}: {away} accepts differ away from the MH borderline")
    require(border_max is None or border <= border_max * n,
            f"{label}: {border} chains split at the borderline")
    if wild_max is None:
        require(drifted + wild <= drift_max * n,
                f"{label}: {drifted + wild} of {n} proposals drifted")
    else:
        require(drifted <= drift_max * n, f"{label}: {drifted} of {n} proposals drifted")
        require(wild <= wild_max * n, f"{label}: {wild} of {n} proposals diverged apart")
    return err, in_step


def _fields(out, t=None, proposal=False):
    """Named fields of a kernel/plain result tuple, at transition t for
    the multistep layout; with `proposal`, the proposal too (in the
    multistep layout, which writes none, the new state: that of an
    accepted chain is its proposal)."""
    if t is None:
        q, lp, grad, acc, dh, prop_q, prop_lp = out
        f = {"q": q, "lp": lp, "grad": grad, "accept": acc, "delta_h": dh}
    else:
        _, _, _, acc, dh, hist_q, hist_lp = out
        f = {"q": hist_q[t], "lp": hist_lp[t], "accept": acc[t], "delta_h": dh[t]}
        prop_q, prop_lp = f["q"], f["lp"]
    if proposal:
        f.update(prop_q=prop_q, prop_lp=prop_lp)
    return f


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
                             torch.log(u), flags=True)
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
                                  _fields(plain, t), torch.log(u_all[t]), alive, flags=True)
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


def _split_check(label, agree, err, within, tol=1e-4, max_split=SPLIT_MAX):
    """An accept test at its margin may come out the other way under another
    summation order, after which the chain's path differs: at most
    `max_split` of the chains may split, and the rest must agree within
    tol."""
    n = agree.numel()
    n_split = n - int(agree.sum())
    say(f"  {label}: discrete state identical on {n - n_split}/{n} chains "
        f"({n_split} split), max |err| {err:.3g} on those")
    require(n_split <= max_split * n, f"{label}: {n_split} of {n} chains split")
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


def phase_parity_dense(torch, ft, targets, row, dev):
    """Kernels 1a and 2a against their plain versions at the dense-warmup
    row's shapes (65,536 x 50, L = 16; 4,096 x 50, T = 8), and 1a and
    kernel 1 (the metric's diagonal) at its 4,096-chain warmups' shape, with
    the learned metric at the tuned step and gamma, from the warmed
    positions: injected draws, then Philox. A chain whose accept decisions differ has split (at
    most SPLIT_MAX of them); the rest agree within 1e-4 (delta H within
    2e-3, a difference of two energies of magnitude ~100)."""
    say("[3d] kernels 1a and 2a (dense metric) vs plain versions: the learned metric "
        "at the tuned step")
    t = _target(targets, "correlated_gaussian")
    info = t.value_and_grad_fn.kernel_info
    invm, l_inv = ft.prepare_dense_metric(row["inv_mass"])
    diag = torch.diagonal(invm).contiguous()
    scalars = ft.kernel_scalars(row["step"], row["gamma"], row["steepness"], dev)
    sid = ft.SCHEDULE_IDS["constant"]
    g = _gen(torch, dev, 103)
    key = ft.PhiloxStream.from_generator(g, dev).key
    max_err = {}
    for name, n, lead, metric, factor in (
            ("grahmc_step_kernel[dense]", CHAINS, (), invm, l_inv),
            ("grahmc_multistep_kernel[dense]", MULTI_CHAINS, (MULTI_T,), invm, l_inv),
            ("grahmc_step_kernel[dense] (4,096 chains)", MULTI_CHAINS, (), invm, l_inv),
            ("grahmc_step_kernel (4,096 chains)", MULTI_CHAINS, (), diag, None)):
        max_err[name] = 0.0
        q = row["pos"][:n].contiguous()
        lp, grad = t.value_and_grad_fn(q)
        args = (info, NUM_STEPS, sid, *lead, q, lp.contiguous(), grad.contiguous(), scalars,
                metric)
        p0 = ft.unwhiten(torch.randn(lead + (n, DIM), generator=g, device=dev), metric, factor)
        u = torch.rand(lead + (n,), generator=g, device=dev).clamp_min(2.0 ** -25)
        kernel_fn, plain_fn = ((ft.grahmc_multistep_kernel, ft.grahmc_multistep_plain) if lead
                               else (ft.grahmc_step_kernel, ft.grahmc_step_plain))
        for mode, rand in (("injected", dict(p0=p0.contiguous(), u=u)),
                           ("philox", dict(key=key, call=7))):
            kern = kernel_fn(*args, l_inv=factor, **rand)
            plain = plain_fn(*args, l_inv=factor, **rand)
            torch.cuda.synchronize()
            if lead:      # (q, lp, grad, accept (T, C), dh (T, C), hist_q, hist_lp)
                agree = (kern[3] == plain[3]).all(dim=0)
                pairs = [(kern[i][agree], plain[i][agree]) for i in (0, 1, 2)]
                pairs += [(kern[i][:, agree], plain[i][:, agree]) for i in (5, 6)]
                dh = (kern[4][:, agree], plain[4][:, agree])
            else:         # (q, lp, grad, accept, dh, proposal q, proposal lp)
                agree = kern[3] == plain[3]
                pairs = [(kern[i][agree], plain[i][agree]) for i in (0, 1, 2, 5, 6)]
                dh = (kern[4][agree], plain[4][agree])
            err, within = _close_on(pairs)
            _split_check(f"{name} {mode}", agree, err, within)
            require(_close_on([dh], tol=2e-3)[1], f"{name} {mode}: delta H differs")
            max_err[name] = max(max_err[name], err)
    return max_err


def _clone_state(ps):
    return type(ps)(*(None if t is None else t.clone() for t in ps))


def _target(targets, family):
    """The rows' DIM-dimensional target of `family` (rho = DENSE_RHO for the
    correlated Gaussian)."""
    if family == "correlated_gaussian":
        return targets.get_target(family, dim=DIM, correlation=DENSE_RHO)
    return targets.get_target(family, dim=DIM)


def phase_parity_nuts(torch, ft, fn, tn, targets, dev):
    """Kernel 4's four variants against their plain versions at the rows'
    shapes (65,536 x 50, 16 iterations x W = 4, depth 10) from a state in
    mid-flight: injected draws, then Philox. The endpoint scheme on the
    standard normal and the funnel (the NUTS row), the multinomial scheme on
    the funnel (the NUTS-multinomial row), the dense metric alone and with
    the multinomial scheme on the correlated Gaussian with its oracle metric
    (the dense row). On the Gaussians every chain that does not split must
    agree in every field. On the funnel, the leapfrog is unstable in the
    neck at this step (exp(x0 / 2) below the step), so there a rounding
    difference grows within a subtree until the subtree ends divergent: the
    trajectory in flight may differ on up to IN_FLIGHT_MAX of the chains,
    while the emitted state is held to the SPLIT_MAX rule."""
    say("[3c] kernel 4 (persistent NUTS window), four variants, vs plain version")
    max_err = dict.fromkeys(NUTS_NAMES.values(), 0.0)
    for family, multinomial, dense, step, in_flight_max in (
            ("standard_normal", False, False, NUTS_PARITY_STEP, SPLIT_MAX),
            ("neals_funnel", False, False, NUTS_PARITY_STEP, IN_FLIGHT_MAX),
            ("neals_funnel", True, False, NUTS_PARITY_STEP, IN_FLIGHT_MAX),
            ("correlated_gaussian", False, True, DENSE_PARITY_STEP, SPLIT_MAX),
            ("correlated_gaussian", True, True, DENSE_PARITY_STEP, SPLIT_MAX)):
        t = _target(targets, family)
        g = _gen(torch, dev, 102)
        q = torch.randn((NUTS_CHAINS, DIM), generator=g, device=dev) * 0.5
        lp, grad = t.value_and_grad_fn(q)
        inv_mass, l_inv = ft.kernel_metric((t.true_cov if dense else torch.ones(DIM)).to(dev))
        key = ft.PhiloxStream.from_generator(g, dev).key
        name, err = _nuts_window_check(torch, fn, tn, t.value_and_grad_fn.kernel_info,
                                       (q, lp, grad), g, key, step, inv_mass, l_inv, multinomial,
                                       family, in_flight_max, dev)
        max_err[name] = max(max_err[name], err)
    return max_err

def _mixture_state(torch, t, n, seed, dev, beta_row=None):
    """(q, lp, grad) of the mixture from its init_sampler (half the chains
    near each mode), tempered by `beta_row` when given."""
    q = t.init_sampler(_gen(torch, dev, seed), n)
    lp, grad = t.value_and_grad_fn(q)
    if beta_row is not None:
        lp, grad = beta_row * lp, beta_row[:, None] * grad
    return q, lp.contiguous(), grad.contiguous()


def phase_parity_variants(torch, ft, targets, samplers, dev):
    """Kernels 1b and 1c against their plain versions at the rows' shapes:
    1b over the tempered row's 6 x 8,192 x 10 replicas with its rung table
    (eps_k = 0.5 / sqrt(beta_k), tanh gamma 0.1, steepness 5, L = 16); 1c at
    65,536 x 10, L = 16 for beta 0.05, 0.5 and 1 on the bridge to N(0, 6^2
    I); injected draws, then Philox (_compare: at most SPLIT_MAX of the
    chains split away from the MH borderline; the mixture's barrier is a
    concave ridge where the leapfrog at the hot rungs' long steps is
    unstable, so up to IN_FLIGHT_MAX of the proposals may drift; lp and grad
    held at the kernel's q). Then the beta = 1 identity:
    1b (one rung) and 1c give kernel 1's results bit for bit (at MOVE_P
    chains all three run 4-lane groups, 1c its lp at a trajectory's last
    substep alone)."""
    say("[3e] kernels 1b (scaled) and 1c (bridged) vs plain versions on the card")
    t = targets.get_target("gaussian_mixture", dim=TEMP_DIM)
    info = t.value_and_grad_fn.kernel_info
    ones = torch.ones(TEMP_DIM, device=dev)
    g = _gen(torch, dev, 104)
    key = ft.PhiloxStream.from_generator(g, dev).key
    tanh = ft.SCHEDULE_IDS["tanh"]
    max_err = {"grahmc_scaled_kernel": 0.0, "grahmc_bridged_kernel": 0.0}

    def randoms(n):
        """Injected draws and Philox, each with its log u."""
        u = torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25)
        return (("injected", dict(p0=torch.randn((n, TEMP_DIM), generator=g, device=dev), u=u),
                 torch.log(u)),
                ("philox", dict(key=key, call=7), torch.log(ft.philox_uniform(key, 7, 0, n, dev))))

    def check(name, label, kernel_fn, plain_fn, args, n, potential):
        for mode, rand, log_u in randoms(n):
            kern = kernel_fn(*args, **rand)
            plain = plain_fn(*args, **rand)
            torch.cuda.synchronize()
            err, _ = _compare(f"{label} {mode}", torch, _fields(kern, proposal=True),
                              _fields(plain, proposal=True), log_u, potential=potential,
                              vs_plain=("q",), away_max=SPLIT_MAX, drift_max=IN_FLIGHT_MAX)
            max_err[name] = max(max_err[name], err)

    n = TEMP_K * TEMP_CHAINS
    betas = samplers.geometric_ladder(TEMP_K, TEMP_BETA_MIN, device=dev)
    beta_row = betas.repeat_interleave(TEMP_CHAINS)
    rungs = ft.rung_table(TEMP_STEP / torch.sqrt(betas), TEMP_GAMMA, TEMP_STEEP, betas, dev)
    state = _mixture_state(torch, t, n, 105, dev, beta_row)
    check("grahmc_scaled_kernel", f"1b {TEMP_K} x {TEMP_CHAINS}", ft.grahmc_scaled_kernel,
          ft.grahmc_scaled_plain, (info, TEMP_L, tanh, *state, rungs, ones), n,
          ft.scaled_vag(ft.device_vag(info), beta_row))

    base = ft.bridge_base(None, SMC_BASE_SCALE, TEMP_DIM, dev)
    q = t.init_sampler(_gen(torch, dev, 106), MOVE_P)
    for beta in (0.05, 0.5, 1.0):
        potential = ft.bridged_vag(ft.device_vag(info), torch.tensor(beta, device=dev),
                                   torch.tensor(base.log_norm, dtype=torch.float32,
                                                device=dev), base.mean, base.inv_scale)
        lp, grad = potential(q)
        args = (info, MOVE_L, 0, q, lp.contiguous(), grad.contiguous(),
                ft.bridge_scalars(SMC_STEP, 0.0, 1.0, beta, base.log_norm, dev), base.mean,
                base.inv_scale, ones)
        check("grahmc_bridged_kernel", f"1c beta {beta}", ft.grahmc_bridged_kernel,
              ft.grahmc_bridged_plain, args, MOVE_P, potential)

    q, lp, grad = _mixture_state(torch, t, MOVE_P, 107, dev)
    for mode, rand, _ in randoms(MOVE_P):
        plain = ft.grahmc_step_kernel(info, TEMP_L, tanh, q, lp, grad,
                                      ft.kernel_scalars(TEMP_STEP, TEMP_GAMMA, TEMP_STEEP, dev),
                                      ones, **rand)
        scaled = ft.grahmc_scaled_kernel(
            info, TEMP_L, tanh, q, lp, grad,
            ft.rung_table(TEMP_STEP, TEMP_GAMMA, TEMP_STEEP, 1.0, dev), ones, **rand)
        bridged = ft.grahmc_bridged_kernel(
            info, TEMP_L, tanh, q, lp, grad,
            ft.bridge_scalars(TEMP_STEP, TEMP_GAMMA, TEMP_STEEP, 1.0, base.log_norm, dev),
            base.mean, base.inv_scale, ones, **rand)
        torch.cuda.synchronize()
        for name, out in (("1b", scaled), ("1c", bridged)):
            require(all(torch.equal(a, b) for a, b in zip(out, plain)),
                    f"{name} at beta = 1 ({mode}) differs from kernel 1")
        say(f"  beta = 1 ({mode}): 1b and 1c equal kernel 1 bit for bit on {MOVE_P} chains "
            f"(accept {float(plain[3].float().mean()):.4f})")
    return max_err


def _family_target(targets, family, dim):
    """The kernel family's target at `dim`: get_target's, or the RAHMC
    paper's factories at the JAX package's parameters for the L1 shells
    (their get_target names fix D at 2 or 3)."""
    if family in ("concentric_l1_balls", "nested_l1_balls"):
        return getattr(targets.rahmc_paper, family)(dim=dim)
    return targets.get_target(family, dim=dim)


def _family_state(torch, targets, family, dim, n, seed, dev):
    """(target, q, lp, grad) of `family` at `dim`, q in the family's bulk:
    log_gamma in [0.5, 2.5] (away from its support's boundary), the
    ill-conditioned Gaussian at its scales, the mixture half in each mode,
    Rosenbrock within N(1, 0.05^2) of its mode, the RAHMC families from
    their init samplers, the others N(0, 0.5^2) (shifted by 0.4 for the
    unconstrained gamma)."""
    t = _family_target(targets, family, dim)
    g = _gen(torch, dev, seed)
    q = torch.randn((n, dim), generator=g, device=dev) * 0.5
    if family == "rosenbrock":
        q = 1.0 + 0.1 * q
    elif family in RAHMC_FAMILIES:
        q = t.init_sampler(g, n)
    elif family == "log_gamma":
        q = torch.rand((n, dim), generator=g, device=dev) * 2.0 + 0.5
    elif family == "log_gamma_unconstrained":
        q = q + 0.4
    elif family == "ill_conditioned_gaussian":
        q = q * torch.sqrt(torch.linspace(1.0, 100.0, dim, device=dev))
    elif family == "gaussian_mixture":
        q = t.init_sampler(g, n)
    lp, grad = t.value_and_grad_fn(q)
    return t, q.contiguous(), lp.contiguous(), grad.contiguous()


def phase_parity_families(torch, ft, fr, fn, tn, targets, dev):
    """The families of the ChEES slice, Rosenbrock and the RAHMC paper's
    three in every kernel and variant that dispatches on them, and the gap
    pairs the ChEES slice closed (the correlated Gaussian in kernel 3, the
    mixture in kernels 3 and 4), against the plain versions at D = 10 and
    50 (the RAHMC families at RAHMC_PARITY_DIMS, which must hold the D of
    each of their [5o] cells) on 16,384 chains, injected draws and
    Philox: kernel 1 with a random diagonal metric, 1a with a random dense
    one, 1b over four rungs (betas 1, 0.5, 0.2, 0.05), 1c at beta 0.5 on
    the bridge to N(0.5, 2^2 I), kernels 2 and 2a at T = 8 (_compare: no
    split away from the MH borderline, SPLIT_MAX at it, proposals drifted
    and diverged apart within FAMILY_DRIFT's bounds, chains leaving the
    multistep comparison once split or drifted); kernel 3 at T = 32 (no
    chain may split where the plain version sums in the kernel's order,
    LANE_ORDER_FAMILIES; SPLIT_MAX on the mixture); kernel 4, 4a and 4b
    over 16 iterations x W = 4 from a state one window in
    (_nuts_window_check: SPLIT_MAX split, the trajectory in flight drifting
    within FAMILY_DRIFT's bound). Returns the max |err| per kernel
    entry, and per (kernel, family) pair of the RAHMC families at the D of
    the family's first [5o] cell, the one [6h] times, and of the sweep's
    families at its D, the one [6i] times."""
    say("[3g] the ChEES slice's families, Rosenbrock and the RAHMC families (and the gap "
        "pairs) in every kernel vs plain versions")
    from mcmc_tpu_torch.ops.padded_targets import LANE_ORDER_FAMILIES, device_lp
    max_err = {}
    n = FAMILY_CHAINS
    tanh = ft.SCHEDULE_IDS["tanh"]

    pair_dim = {}
    for cell, (name, dim, *_) in RAHMC_CELLS.items():
        family = targets.get_target(name, dim=dim).value_and_grad_fn.kernel_info["family"]
        require(dim in RAHMC_PARITY_DIMS[family],
                f"[3g] holds {family} at no D = {dim}, the shape of [5o]'s {cell} cell")
        pair_dim.setdefault(family, dim)
    require(SWEEP_DIM in FAMILY_DIMS, f"[3g] holds the sweep's families at no D = {SWEEP_DIM}")
    pair_dim.update(dict.fromkeys(NEW_FAMILIES, SWEEP_DIM))

    def note(name, err, family, dim):
        """The kernel's max |err|, and the new families' per (kernel, family)
        pair as the kernels line lists them, at the pair's timed shape."""
        max_err[name] = max(max_err.get(name, 0.0), err)
        if pair_dim.get(family) == dim:
            pair = f"{name} ({family})"
            max_err[pair] = max(max_err.get(pair, 0.0), err)

    cases = [(f, d) for d in FAMILY_DIMS for f in FAMILY_KERNELS if f not in RAHMC_PARITY_DIMS]
    cases += [(f, d) for f, dims in RAHMC_PARITY_DIMS.items() for d in dims]
    for family, dim in cases:
        kernels = FAMILY_KERNELS[family]
        t, q, lp, grad = _family_state(torch, targets, family, dim, n, 130 + dim, dev)
        info = t.value_and_grad_fn.kernel_info
        g = _gen(torch, dev, 131 + dim)
        key = ft.PhiloxStream.from_generator(g, dev).key
        eps = FAMILY_STEP[family]
        drift, wild, in_flight_max = FAMILY_DRIFT.get(family, (0.0, 0.0, SPLIT_MAX))
        tag = f"{family} D={dim}"
        vag = ft.device_vag(info)
        if "grahmc" in kernels:
            diag = torch.rand(dim, generator=g, device=dev) + 0.5
            a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
            dense = ft.prepare_dense_metric(
                a @ a.T / dim + 0.5 * torch.eye(dim, device=dev, dtype=torch.float64))
            betas = torch.tensor([1.0, 0.5, 0.2, 0.05], device=dev)
            beta_row = betas.repeat_interleave(n // 4)
            base = ft.bridge_base(0.5, 2.0, dim, dev)
            half = torch.tensor(0.5, device=dev)
            bridge = ft.bridged_vag(vag, half, torch.tensor(base.log_norm, device=dev),
                                    base.mean, base.inv_scale)
            blp, bgrad = bridge(q)
            scalars = ft.kernel_scalars(eps, 0.3, 2.0, dev)
            cases = [
                ("grahmc_step_kernel", ft.grahmc_step_kernel, ft.grahmc_step_plain,
                 (info, FAMILY_L, tanh, q, lp, grad, scalars, diag), None, vag),
                ("grahmc_step_kernel[dense]", ft.grahmc_step_kernel, ft.grahmc_step_plain,
                 (info, FAMILY_L, tanh, q, lp, grad, scalars, dense.invm), dense.l_inv, vag),
                ("grahmc_scaled_kernel", ft.grahmc_scaled_kernel, ft.grahmc_scaled_plain,
                 (info, FAMILY_L, tanh, q, (beta_row * lp).contiguous(),
                  (beta_row[:, None] * grad).contiguous(),
                  ft.rung_table(eps / torch.sqrt(betas), 0.3, 2.0, betas, dev), diag),
                 None, ft.scaled_vag(vag, beta_row)),
                ("grahmc_bridged_kernel", ft.grahmc_bridged_kernel, ft.grahmc_bridged_plain,
                 (info, FAMILY_L, 0, q, blp.contiguous(), bgrad.contiguous(),
                  ft.bridge_scalars(eps, 0.0, 1.0, 0.5, base.log_norm, dev), base.mean,
                  base.inv_scale, diag), None, bridge)]
            for name, kernel_fn, plain_fn, args, l_inv, potential in cases:
                for mode, rand, log_u in _family_randoms(torch, ft, g, key, n, dim,
                                                         args[-1], l_inv, dev):
                    kern = kernel_fn(*args, l_inv=l_inv, **rand)
                    plain = plain_fn(*args, l_inv=l_inv, **rand)
                    torch.cuda.synchronize()
                    err, _ = _compare(f"{name} {tag} {mode}", torch,
                                      _fields(kern, proposal=True),
                                      _fields(plain, proposal=True), log_u,
                                      potential=potential, border_max=SPLIT_MAX,
                                      drift_max=drift, wild_max=wild)
                    note(name, err, family, dim)
            for name, metric, l_inv in (("grahmc_multistep_kernel", diag, None),
                                        ("grahmc_multistep_kernel[dense]", dense.invm,
                                         dense.l_inv)):
                margs = (info, FAMILY_L, tanh, MULTI_T, q, lp, grad, scalars, metric)
                for mode, rand, log_us in _multi_randoms(torch, ft, g, key, n, dim, metric,
                                                         l_inv, dev):
                    kern = ft.grahmc_multistep_kernel(*margs, l_inv=l_inv, **rand)
                    plain = ft.grahmc_multistep_plain(*margs, l_inv=l_inv, **rand)
                    torch.cuda.synchronize()
                    alive = None
                    for s in range(MULTI_T):
                        err, alive = _compare(
                            f"{name} {tag} {mode} t={s}", torch,
                            _fields(kern, s, proposal=True), _fields(plain, s, proposal=True),
                            log_us[s], alive, border_max=SPLIT_MAX, drift_max=drift,
                            wild_max=wild, dh_accepted_only=drift > 0)
                        note(name, err, family, dim)
        if "rwmh" in kernels:
            rlp = device_lp(info)(q).contiguous()
            scale = fr.rwmh_scale(0.5 * eps, dev)
            noise = torch.randn((RWMH_T, n, dim), generator=g, device=dev)
            u = torch.rand((RWMH_T, n), generator=g, device=dev).clamp_min(2.0 ** -25)
            max_split = 0.0 if family in LANE_ORDER_FAMILIES else SPLIT_MAX
            for mode, rand in (("injected", dict(noise=noise, u=u)),
                               ("philox", dict(key=key, call=5))):
                rargs = (info, RWMH_T, q, rlp, scale, COLLECT)
                kern = fr.rwmh_multistep_kernel(*rargs, **rand)
                plain = fr.rwmh_multistep_plain(*rargs, **rand)
                torch.cuda.synchronize()
                agree = (kern[2] == plain[2]).all(dim=0)
                hist = agree[:COLLECT]
                err, within = _close_on([(kern[0][agree], plain[0][agree]),
                                         (kern[1][agree], plain[1][agree]),
                                         (kern[3][:, hist], plain[3][:, hist]),
                                         (kern[4][:, hist], plain[4][:, hist])])
                _split_check(f"rwmh_multistep_kernel {tag} {mode}", agree, err, within,
                             max_split=max_split)
                note("rwmh_multistep_kernel", err, family, dim)
        if "nuts" in kernels:
            nstep = 1.0 if family == "ill_conditioned_gaussian" else 1.5 * eps
            for multinomial, dense_m in ((False, False), (True, False), (False, True)):
                if dense_m:
                    a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
                    inv_mass, l_inv = ft.kernel_metric(
                        a @ a.T / dim + 0.5 * torch.eye(dim, device=dev, dtype=torch.float64))
                else:
                    inv_mass, l_inv = torch.rand(dim, generator=g, device=dev) + 0.5, None
                name, err = _nuts_window_check(
                    torch, fn, tn, info, (q, lp, grad), g, key,
                    nstep * (0.5 if dense_m else 1.0), inv_mass, l_inv, multinomial, tag,
                    in_flight_max, dev)
                note(name, err, family, dim)
    return max_err


def _family_randoms(torch, ft, g, key, n, dim, metric, l_inv, dev):
    """Kernel 1's injected draws (momentum unwhitened by `metric`) and its
    Philox mode, each with its log u: [(mode, draws, log u)]."""
    u = torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25)
    p0 = ft.unwhiten(torch.randn((n, dim), generator=g, device=dev), metric, l_inv)
    return (("injected", dict(p0=p0.contiguous(), u=u), torch.log(u)),
            ("philox", dict(key=key, call=7), torch.log(ft.philox_uniform(key, 7, 0, n, dev))))


def _multi_randoms(torch, ft, g, key, n, dim, metric, l_inv, dev):
    """Kernel 2's injected (T, C, D) draws and its Philox mode, each with
    its T rows of log u."""
    u = torch.rand((MULTI_T, n), generator=g, device=dev).clamp_min(2.0 ** -25)
    z = torch.randn((MULTI_T * n, dim), generator=g, device=dev)
    p0 = ft.unwhiten(z, metric, l_inv).reshape(MULTI_T, n, dim).contiguous()
    philox_u = torch.stack([ft.philox_uniform(key, 3, s, n, dev) for s in range(MULTI_T)])
    return (("injected", dict(p0=p0, u=u), torch.log(u)),
            ("philox", dict(key=key, call=3), torch.log(philox_u)))


def _nuts_window_check(torch, fn, tn, info, state, g, key, step, inv_mass, l_inv,
                       multinomial, tag, in_flight_max, dev):
    """Kernel 4 (the variant the scheme and metric pick) against its plain
    version, 16 iterations x W = 4 from `state` one window in (the warm
    window by the kernel, Philox call 0), injected draws from `g`, then
    Philox: window_agreement; at most SPLIT_MAX of the chains split (the
    discrete state or the emitted state apart), at most `in_flight_max`
    whose trajectory in flight drifted. Returns the variant's entry name
    and its max |err|."""
    q, lp, grad = state
    n, dim = q.shape
    scalars = fn.nuts_scalars(step, 1000.0, dev)
    args = (info, NUTS_ITERS, NUTS_W, NUTS_DEPTH)
    start = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial,
                            max_tree_depth=NUTS_DEPTH)
    warm = fn.nuts_window_kernel(*args, start, scalars, inv_mass, key=key, call=0, l_inv=l_inv)
    shape = (NUTS_ITERS, n)
    n_slice = NUTS_ITERS * NUTS_W if multinomial else NUTS_ITERS
    draws = (torch.randn(shape + (dim,), generator=g, device=dev),
             torch.rand(shape, generator=g, device=dev) < 0.5,
             torch.rand(shape, generator=g, device=dev) < 0.5,
             torch.rand(shape, generator=g, device=dev),
             torch.rand((n_slice, n), generator=g, device=dev).clamp_min(2.0 ** -25),
             torch.rand(shape, generator=g, device=dev))
    name = NUTS_NAMES[fn.variant(warm, inv_mass)]
    max_err = 0.0
    for mode, rand in (("injected", dict(draws=draws)), ("philox", dict(key=key, call=1))):
        kern = fn.nuts_window_kernel(*args, _clone_state(warm), scalars, inv_mass, l_inv=l_inv,
                                     **rand)
        plain = fn.nuts_window_plain(*args, _clone_state(warm), scalars, inv_mass, l_inv=l_inv,
                                     **rand)
        torch.cuda.synchronize()
        same, emitted, in_flight, err = fn.window_agreement(kern, plain)
        kept = same & emitted
        split = n - int(kept.sum())
        drift = int((kept & ~in_flight).sum())
        done = int((kern.transitions - warm.transitions).sum())
        executed = int((kern.n_exec - warm.n_exec).sum())
        label = f"{name} {tag} {mode}"
        say(f"  {label}: discrete state identical on {int(same.sum())}/{n}, emitted within "
            f"1e-4 on {n - split} ({split} split), in flight on {n - split - drift} ({drift} "
            f"drifted); max |err| {err:.3g}; {done} transitions, {executed} of "
            f"{n * NUTS_STEPS_PER_SAMPLE} slots executed, divergent "
            f"{int((kern.divergences - warm.divergences).sum())}")
        require(split <= SPLIT_MAX * n, f"{label}: {split} chains split")
        require(drift <= in_flight_max * n, f"{label}: {drift} trajectories in flight differ")
        require(done > 0, f"{label}: no transition completed")
        max_err = max(max_err, err)
    return name, max_err


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


def _da_tune_nuts(torch, tuning, samplers, dev, t, chains, init=None, **kw):
    """The NUTS row's step-size tune: NUTS_TUNE_CALLS one-window runs of
    NUTS_TUNE_SPS slots, each from the last one's final state (the first
    from `init`, default N(0, 0.5^2) draws), dual averaging on the
    batch-mean accept with no host read inside. Returns (the smoothed step
    as a device tensor, the last run's final positions)."""
    pos = init if init is not None else torch.randn(
        (chains, DIM), generator=_gen(torch, dev, 11), device=dev) * 0.5
    da = tuning.da_init(DA_INIT_STEP, device=dev)
    for i in range(NUTS_TUNE_CALLS):
        res = samplers.nuts_run_persistent(
            _gen(torch, dev, 12 + i), t.log_prob_fn, pos,
            step_size=tuning.da_step_size(da), num_samples=1,
            steps_per_sample=NUTS_TUNE_SPS, value_and_grad_fn=t.value_and_grad_fn,
            collect_chains=8, **kw)
        pos = res.final_state.position
        da = tuning.da_update(da, torch.nanmean(res.info["mean_accept_probs"]),
                              TARGET_ACCEPT)
    return tuning.da_final_step_size(da), pos


def _nuts_timed(torch, samplers, diagnostics, dev, t, label, seed, chains=NUTS_CHAINS,
                reps=NUTS_REPS, init=None, **kw):
    """bench.py's NUTS protocol: from `init` (default N(0, 0.5^2) starts,
    fixed seed 3), a warm-up and `reps` timed runs of NUTS_SAMPLES draws x
    64 slots keeping the full history; the median useful (executed-leapfrog)
    grads/s over reps 2 and up, and the min bulk-ESS of the last rep's
    history over its wall time. Checks shapes, finite draws and the leapfrog
    counters."""
    if init is None:
        init = torch.randn((chains, DIM), generator=_gen(torch, dev, 3), device=dev) * 0.5
    dim = init.shape[1]
    kw = dict(kw, num_samples=NUTS_SAMPLES, steps_per_sample=NUTS_STEPS_PER_SAMPLE,
              value_and_grad_fn=t.value_and_grad_fn)
    res = samplers.nuts_run_persistent(_gen(torch, dev, seed), t.log_prob_fn, init, **kw)
    del res
    torch.cuda.synchronize()
    runs = []
    for rep in range(reps):
        t0 = time.perf_counter()
        res = samplers.nuts_run_persistent(_gen(torch, dev, seed + 1 + rep), t.log_prob_fn,
                                           init, **kw)
        torch.cuda.synchronize()
        runs.append((int(res.info["n_leapfrogs"]), time.perf_counter() - t0))
        if rep < reps - 1:
            del res
    rates = sorted(n / d for n, d in runs[1:] or runs)
    slots = NUTS_SAMPLES * NUTS_STEPS_PER_SAMPLE * chains
    out = dict(rate=rates[len(rates) // 2], wall=runs[-1][1],
               accept=float(torch.nanmean(res.info["mean_accept_probs"])),
               depth=float(res.info["mean_tree_depth"].mean()),
               divergences=int(res.info["total_divergences"]),
               executed=runs[-1][0] / slots)
    say(f"  {label}: {NUTS_SAMPLES} draws x {NUTS_STEPS_PER_SAMPLE} slots x {chains} "
        f"chains; reps (leapfrogs, s) {[(n, round(d, 4)) for n, d in runs]}")
    which = f"median of reps 2-{reps}" if reps > 1 else "one rep"
    say(f"  {label}: useful grads/s {out['rate']:.1f} ({which}); "
        f"executed {out['executed']:.4f} of the slots; accept {out['accept']:.4f}; "
        f"mean tree depth {out['depth']:.3f}; divergences {out['divergences']}")
    require(res.samples.shape == (NUTS_SAMPLES, chains, dim), f"{label}: history shape")
    require(bool(torch.isfinite(res.samples).all()), f"{label}: non-finite draws")
    require(bool(torch.isfinite(res.log_probs).all()), f"{label}: non-finite log-probs")
    require(int(res.info["n_leapfrogs"]) <= int(res.info["n_leapfrog_slots"]) == slots,
            f"{label}: leapfrog counters")
    t0 = time.perf_counter()
    ess = diagnostics.ess_bulk_chunked(res.samples, chain_chunk=8192, dim_chunk=4)
    torch.cuda.synchronize()
    out["ess_min"] = float(ess.min())
    out["ess_rate"] = out["ess_min"] / out["wall"]
    out["ess"] = ess
    require(bool(torch.isfinite(ess).all()) and out["ess_min"] > 0, f"{label}: bulk ESS")
    say(f"  {label}: last rep's full history: min bulk-ESS {out['ess_min']:.1f}, median "
        f"{float(ess.median()):.1f}, ESS/s {out['ess_rate']:.1f} "
        f"(diagnostics {time.perf_counter() - t0:.2f} s)")
    return out, res


def phase_nuts_row(torch, targets, samplers, tuning, diagnostics, dev):
    """bench.py's NUTS row on the port: DA tune through the persistent path
    (NUTS_TUNE_CALLS one-window runs, no host read inside), then 192 draws of
    64 slots at 65,536 chains, a warm-up and NUTS_REPS timed reps (first
    dropped), the median per-rep useful grads/s and the last rep's
    full-history ESS; then bench.py's NUTS-multinomial row, the same run
    with the multinomial scheme at the same step (bench.py:453-493)."""
    say("[5b] NUTS row: 50-D funnel, 65,536 chains, persistent NUTS (kernel 4)")
    t = targets.neals_funnel(DIM)
    t0 = time.perf_counter()
    step_t, _ = _da_tune_nuts(torch, tuning, samplers, dev, t, NUTS_CHAINS)
    step = float(step_t)
    say(f"  tuned step {step:.6f} ({NUTS_TUNE_CALLS} runs of {NUTS_TUNE_SPS} slots, "
        f"{time.perf_counter() - t0:.2f} s)")
    require(0.0 < step < 1.0, "tuned NUTS step out of range")
    endpoint, _ = _nuts_timed(torch, samplers, diagnostics, dev, t, "endpoint", 4,
                              step_size=step_t)
    say(f"  nuts_useful_grads_per_sec {endpoint['rate']:.1f}, nuts_ess_per_sec "
        f"{endpoint['ess_rate']:.1f}")
    require(abs(endpoint["accept"] - TARGET_ACCEPT) < 0.1,
            f"tuned NUTS accept {endpoint['accept']}")

    say("[5b'] NUTS-multinomial row: the same funnel, step and starts, "
        "proposal_scheme='multinomial' (kernel 4a)")
    multi, _ = _nuts_timed(torch, samplers, diagnostics, dev, t, "multinomial", 40,
                           step_size=step_t, proposal_scheme="multinomial")
    ratio = multi["ess_rate"] / endpoint["ess_rate"]
    say(f"  nuts_multinomial_useful_grads_per_sec {multi['rate']:.1f}, "
        f"nuts_multinomial_ess_per_sec {multi['ess_rate']:.1f}, "
        f"nuts_multinomial_vs_endpoint_ess {ratio:.4f}")
    require(0.4 < multi["accept"] <= 1.0, f"multinomial accept {multi['accept']}")
    return dict(step=step, endpoint=endpoint, multinomial=multi, vs_endpoint=ratio)


def phase_dense_row(torch, targets, samplers, tuning, diagnostics, dev):
    """The dense-metric NUTS row (the port's own; bench.py has none): the
    50-D rho = 0.9 correlated Gaussian at 65,536 chains with the oracle
    metric inv_mass_matrix = its covariance (tests/test_dense_metric.py's
    drive), the step tuned with the NUTS row's protocol, then 192 draws of
    64 slots with the endpoint scheme (kernel 4b) and with the multinomial
    scheme (kernels 4a with 4b), bench.py's timing and ESS protocol. Then
    at 4,096 chains the same endpoint run with the diagonal metric diag(Sigma),
    its step tuned the same way: its min bulk-ESS must be at least
    DENSE_ESS_RATIO times lower (tests/test_dense_metric.py:77)."""
    say("[5c] dense-metric NUTS row: 50-D correlated Gaussian (rho 0.9), 65,536 "
        "chains, oracle metric (kernel 4b)")
    t = _target(targets, "correlated_gaussian")
    sigma = t.true_cov.to(dev)
    t0 = time.perf_counter()
    step_t, _ = _da_tune_nuts(torch, tuning, samplers, dev, t, NUTS_CHAINS,
                           inv_mass_matrix=sigma)
    step = float(step_t)
    say(f"  tuned step {step:.6f} ({NUTS_TUNE_CALLS} runs of {NUTS_TUNE_SPS} slots, "
        f"{time.perf_counter() - t0:.2f} s)")
    require(0.0 < step < 3.0, "tuned dense step out of range")
    dense, res = _nuts_timed(torch, samplers, diagnostics, dev, t, "dense", 60,
                             step_size=step_t, inv_mass_matrix=sigma)
    cov_err = float((torch.cov(res.samples[-1].T.double()) - sigma).abs().max())
    del res
    say(f"  nuts_dense_useful_grads_per_sec {dense['rate']:.1f}, nuts_dense_ess_per_sec "
        f"{dense['ess_rate']:.1f}; last draw's covariance across chains within "
        f"{cov_err:.4f} of Sigma")
    require(abs(dense["accept"] - TARGET_ACCEPT) < 0.1, f"tuned dense accept {dense['accept']}")
    require(cov_err < 0.1, f"dense row covariance off by {cov_err}")
    both, _ = _nuts_timed(torch, samplers, diagnostics, dev, t, "multinomial+dense", 70,
                          step_size=step_t, inv_mass_matrix=sigma,
                          proposal_scheme="multinomial")
    say(f"  nuts_dense_multinomial_useful_grads_per_sec {both['rate']:.1f}, "
        f"nuts_dense_multinomial_ess_per_sec {both['ess_rate']:.1f}")
    require(0.4 < both["accept"] <= 1.0, f"multinomial+dense accept {both['accept']}")

    step_d, _ = _da_tune_nuts(torch, tuning, samplers, dev, t, DENSE_CHECK_CHAINS,
                           inv_mass_matrix=torch.diagonal(sigma))
    check = {}
    for name, metric, s in (("dense", sigma, step_t),
                            ("diagonal", torch.diagonal(sigma), step_d)):
        check[name], _ = _nuts_timed(torch, samplers, diagnostics, dev, t,
                                     f"{name} at {DENSE_CHECK_CHAINS} chains", 80,
                                     chains=DENSE_CHECK_CHAINS, reps=1, step_size=s,
                                     inv_mass_matrix=metric)
    ess_ratio = check["dense"]["ess_min"] / check["diagonal"]["ess_min"]
    say(f"  oracle dense vs diagonal metric at {DENSE_CHECK_CHAINS} chains (steps "
        f"{step:.4f} / {float(step_d):.4f}): min bulk-ESS {check['dense']['ess_min']:.1f} "
        f"vs {check['diagonal']['ess_min']:.1f}, ratio {ess_ratio:.2f}")
    require(ess_ratio >= DENSE_ESS_RATIO, f"dense/diagonal min-ESS ratio {ess_ratio}")
    return dict(step=step, dense=dense, multinomial_dense=both, ess_ratio=ess_ratio)


def phase_multinomial_variance(torch, targets, samplers, dev):
    """The multinomial scheme's point, fused (in-kernel Philox) against
    eager: on the 4-D standard normal from exact starts at 65,536 chains its
    marginal variance lies within VAR_TOL of 1 on both backends, where the
    endpoint scheme reads ~0.967 (nuts_persistent.py:174-176 in the JAX
    package; in 50-D with a unit metric it does not show)."""
    say(f"[4c] multinomial scheme: {VAR_DIM}-D N(0, I) from exact starts, "
        f"{VAR_CHAINS} chains, fused against eager")
    t = targets.standard_normal(VAR_DIM)
    q0 = torch.randn((VAR_CHAINS, VAR_DIM), generator=_gen(torch, dev, 26), device=dev)
    var = {}
    for scheme in ("endpoint", "multinomial"):
        for backend in ("fused", "eager"):
            res = samplers.nuts_run_persistent(
                _gen(torch, dev, 27), t.log_prob_fn, q0, step_size=VAR_STEP,
                num_samples=VAR_SAMPLES, steps_per_sample=NUTS_STEPS_PER_SAMPLE,
                max_tree_depth=VAR_DEPTH, value_and_grad_fn=t.value_and_grad_fn,
                backend=backend, proposal_scheme=scheme)
            flat = res.samples.reshape(-1, VAR_DIM)
            var[scheme, backend] = float(flat.var(0).mean())
            say(f"  {scheme} {backend}: marginal variance {var[scheme, backend]:.4f}, "
                f"max |mean| {float(flat.mean(0).abs().max()):.4f}, accept "
                f"{float(torch.nanmean(res.info['mean_accept_probs'])):.4f}, mean tree "
                f"depth {float(res.info['mean_tree_depth'].mean()):.3f}")
    for backend in ("fused", "eager"):
        v = var["multinomial", backend]
        require(abs(v - 1.0) < VAR_TOL, f"multinomial {backend}: variance {v}")
        require(var["endpoint", backend] < v, f"{backend}: endpoint not below multinomial")
    return var


def phase_rwmh_row(torch, targets, samplers, dev):
    """bench.py's RWMH row on the port: 65,536 chains of the 10-D standard
    normal, 16,384 draws through kernel 3 (T = 32), a warm-up and RWMH_REPS
    timed reps, the median of reps 2 and up; then one profiled rep for the
    device-busy share."""
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
    busy = device_busy_seconds(torch, lambda: samplers.rwmh_run(
        _gen(torch, dev, 8), t.log_prob_fn, r_init, **kw))
    say_busy("RWMH row", busy, dt)
    require(res.samples.shape == (RWMH_SAMPLES, RWMH_COLLECT, RWMH_DIM), "RWMH history shape")
    require(bool(torch.isfinite(res.samples).all()), "non-finite RWMH draws")
    require(0.2 < accept < 0.35, f"RWMH accept {accept}")


def phase_dense_warmup_row(torch, targets, samplers, tuning, diagnostics, dev):
    """The dense-warmup GRAHMC row (the port's own; bench.py has none): from
    N(0, 0.5^2) starts, run_adaptive_warmup("grahmc", learn_mass_matrix=
    "dense", backend="fused") learns a dense metric for the 50-D rho = 0.9
    Gaussian at 65,536 chains with the library's default schedule, then
    tunes gamma by ESJD (all through kernel 1a); then, from the warmed
    positions, the GRAHMC row's protocol (bench.py:328-411) at the tuned
    step, gamma and metric: a warm-up and TIMED_REPS timed 768-draw runs
    keeping a 64-chain history (the median gives
    grahmc_dense_chain_steps_per_sec) and one 192-draw full-history run
    (min bulk-ESS over its wall, grahmc_dense_ess_per_sec). Gates: the
    learned metric within WARMUP_METRIC_TOL of Sigma, accept 0.65 +- 0.1,
    the last draw's covariance within WARMUP_COV_TOL of Sigma. Then at 4,096
    chains a dense and a diagonal warmup, each followed by a 256-draw run
    through the multistep dispatch (kernels 2a and 2): the dense min
    bulk-ESS at least DENSE_ESS_RATIO times the diagonal one. The gamma
    tune's share of the warmup is timed by running the library's
    sequential_tune_grahmc once more, from the warmed positions and metric
    (the same number of transitions as the warmup's own tune)."""
    say("[5e] dense-warmup GRAHMC row: 50-D correlated Gaussian (rho 0.9), 65,536 chains, "
        "dense metric learned by the windowed warmup, gamma by ESJD (kernel 1a)")
    t = _target(targets, "correlated_gaussian")
    sigma = t.true_cov.to(dev)
    constant = samplers.constant_schedule

    def warmup(chains, learn, seed):
        init = torch.randn((chains, DIM), generator=_gen(torch, dev, seed), device=dev) * 0.5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tuning.run_adaptive_warmup(
            "grahmc", t.log_prob_fn, None, init, _gen(torch, dev, seed + 1),
            num_warmup=WARMUP_STEPS, learn_mass_matrix=learn, backend="fused",
            num_steps=NUM_STEPS, schedule_type="constant",
            value_and_grad_fn=t.value_and_grad_fn)
        torch.cuda.synchronize()
        return out + (time.perf_counter() - t0,)

    def run(pos, step, inv_mass, info, seed, **kw):
        return samplers.grahmc_run(
            _gen(torch, dev, seed), t.log_prob_fn, pos, step_size=step, num_steps=NUM_STEPS,
            gamma=info["gamma"], steepness=info["steepness"], burn_in=0,
            friction_schedule=constant, inv_mass_matrix=inv_mass,
            value_and_grad_fn=t.value_and_grad_fn, backend="fused", **kw)

    step, inv_mass, pos, info, warmup_sec = warmup(CHAINS, "dense", 50)
    metric_err = float((inv_mass.double() - sigma).abs().max())
    cond = float(torch.linalg.cond(inv_mass.double()))
    say(f"  grahmc_dense_warmup_sec {warmup_sec:.4f} ({WARMUP_TRANSITIONS} warmup and "
        f"{TUNE_TRANSITIONS} gamma-tune transitions); tuned step {step:.6f}, gamma "
        f"{info['gamma']}")
    say(f"  learned metric: max |M^-1 - Sigma| {metric_err:.5f}, condition number "
        f"{cond:.1f} (Sigma: {float(torch.linalg.cond(sigma)):.1f}); last batch "
        f"accept {info['accept_trace'][-1]:.4f}")
    require(metric_err <= WARMUP_METRIC_TOL, f"learned metric off Sigma by {metric_err}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _s, gamma_again, _st, history = tuning.sequential_tune_grahmc(
        _gen(torch, dev, 59), t.log_prob_fn, None, pos, num_steps=NUM_STEPS,
        inv_mass_matrix=inv_mass, init_step_size=step, value_and_grad_fn=t.value_and_grad_fn,
        backend="fused")
    torch.cuda.synchronize()
    tune_sec = time.perf_counter() - t0
    say(f"  the gamma tune again from the warmed state: {TUNE_TRANSITIONS} transitions in "
        f"{tune_sec:.4f} s, so the windows took {warmup_sec - tune_sec:.4f} s; it picks gamma "
        f"{gamma_again}; per gamma (step, ESJD): "
        + ", ".join(f"{g_}: ({s_:.4f}, {e:.4f})" for g_, s_, e in zip(
            history["gamma_grid"], history["per_gamma_step"], history["esjd"])))

    kw = dict(collect_chains=COLLECT, num_samples=TIMED_SAMPLES)
    res = run(pos, step, inv_mass, info, 52, **kw)               # warm-up
    torch.cuda.synchronize()
    dts = []
    for rep in range(TIMED_REPS):
        t0 = time.perf_counter()
        res = run(pos, step, inv_mass, info, 53 + rep, **kw)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    dt = statistics.median(dts)
    accept = float(res.accept_rate.mean())
    rate = CHAINS * TIMED_SAMPLES / dt
    say(f"  timed runs: {TIMED_SAMPLES} draws x {CHAINS} chains, median of {TIMED_REPS} "
        f"reps {dt:.4f} s (reps {[round(x, 4) for x in dts]}); accept {accept:.4f}; "
        f"grahmc_dense_chain_steps_per_sec {rate:.1f}")
    require(res.samples.shape == (TIMED_SAMPLES, COLLECT, DIM), "dense history shape")
    require(bool(torch.isfinite(res.samples).all()), "non-finite dense draws")
    require(abs(accept - TARGET_ACCEPT) <= 0.1, f"dense tuned accept {accept}")
    del res
    t0 = time.perf_counter()
    full = run(pos, step, inv_mass, info, 60, num_samples=ESS_SAMPLES)
    torch.cuda.synchronize()
    dt_full = time.perf_counter() - t0
    require(full.samples.shape == (ESS_SAMPLES, CHAINS, DIM), "dense full history shape")
    cov_err = float((torch.cov(full.samples[-1].T.double()) - sigma).abs().max())
    ess = diagnostics.ess_bulk_chunked(full.samples, chain_chunk=8192, dim_chunk=4)
    ess_min = float(ess.min())
    del full
    require(bool(torch.isfinite(ess).all()) and ess_min > 0, "dense bulk ESS")
    say(f"  full-history run: {ESS_SAMPLES} draws x {CHAINS} chains in {dt_full:.4f} s; "
        f"min bulk-ESS {ess_min:.1f}, grahmc_dense_ess_per_sec {ess_min / dt_full:.1f}; "
        f"last draw's covariance within {cov_err:.4f} of Sigma")
    require(cov_err <= WARMUP_COV_TOL, f"dense row covariance off by {cov_err}")

    check = {}
    for name, learn, seed in (("dense", "dense", 70), ("diagonal", True, 72)):
        s_c, im_c, pos_c, info_c, sec_c = warmup(MULTI_CHAINS, learn, seed)
        r = run(pos_c, s_c, im_c, info_c, seed + 10, num_samples=MULTI_SAMPLES)
        check[name] = float(diagnostics.ess_bulk_chunked(r.samples, chain_chunk=4096,
                                                         dim_chunk=10).min())
        say(f"  {name} warmup at {MULTI_CHAINS} chains in {sec_c:.2f} s: step {s_c:.4f}, "
            f"gamma {info_c['gamma']}; {MULTI_SAMPLES}-draw run accept "
            f"{float(r.accept_rate.mean()):.4f}, min bulk-ESS {check[name]:.1f}")
    ratio = check["dense"] / check["diagonal"]
    say(f"  learned dense vs diagonal metric at {MULTI_CHAINS} chains: min bulk-ESS ratio "
        f"{ratio:.2f}")
    require(ratio >= DENSE_ESS_RATIO, f"dense/diagonal min-ESS ratio {ratio}")
    return dict(step=step, gamma=info["gamma"], steepness=info["steepness"],
                inv_mass=inv_mass, pos=pos, rate=rate, ess_rate=ess_min / dt_full,
                warmup_sec=warmup_sec, ess_ratio=ratio)


def device_busy_seconds(torch, run):
    """Device time of the CUDA kernels and copies that `run` launches, from
    one torch.profiler trace (0.0 when the profiler saw no device work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6


def say_busy(label, busy, wall):
    if busy > 0.0:
        say(f"  {label}: device busy {busy * 1e3:.3f} ms of the {wall * 1e3:.3f} ms median wall "
            f"({busy / wall:.4f}), one profiled rep")
    else:
        say(f"  {label}: device busy not measured (the profiler saw no device time)")


def _tempered_kw(t, samplers):
    """The tempered row's sampler settings but its ladder and step."""
    return dict(num_steps=TEMP_L, gamma=TEMP_GAMMA, steepness=TEMP_STEEP,
                friction_schedule=samplers.tanh_schedule,
                value_and_grad_fn=t.value_and_grad_fn, backend="auto")


def phase_tempered_row(torch, targets, samplers, dev):
    """bench.py's tempered row on the port: 8,192 chains of the 10-D mixture
    from its init_sampler, a 6-rung geometric ladder to beta 0.02 with
    eps_k = 0.5 / sqrt(beta_k), L = 16, tanh gamma 0.1 (backend "auto",
    which resolves to kernel 1b on the card); two warm runs (a cold start,
    then a continuation) and TEMP_REPS timed runs of 256 draws, each
    continuing from the last one's replicas; the median wall gives
    tempered_replica_transitions_per_sec = K C draws / s. Then one more
    continuation under the profiler for the device-busy share. Gates:
    finite draws, every pair's swap rate > 0.1, cold accept in (0.75, 0.95)
    (the JAX package's bench reads 0.856 here, BENCH_r05.json)."""
    say("[5f] tempered row: 10-D mixture, 6 rungs x 8,192 chains, L = 16 (kernel 1b)")
    t = targets.get_target("gaussian_mixture", dim=TEMP_DIM)
    init = t.init_sampler(_gen(torch, dev, 50), TEMP_CHAINS)
    kw = dict(_tempered_kw(t, samplers), step_size=TEMP_STEP, n_temps=TEMP_K,
              beta_min=TEMP_BETA_MIN, num_samples=TEMP_DRAWS, collect_chains=TEMP_COLLECT)
    box = {"rep": None}

    def run(seed):
        res = samplers.tempered_run(_gen(torch, dev, seed), t.log_prob_fn, init,
                                    init_replica_position=box["rep"], **kw)
        box["rep"] = res.info["replica_final_positions"]
        return res

    for seed in (51, 51):
        run(seed)
    torch.cuda.synchronize()
    dts = []
    for rep in range(TEMP_REPS):
        t0 = time.perf_counter()
        res = run(52 + rep)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    dt = statistics.median(dts)
    rate = TEMP_K * TEMP_CHAINS * TEMP_DRAWS / dt
    swaps = [round(float(x), 4) for x in res.info["swap_accept_rate"]]
    cold = float(res.accept_rate.mean())
    say(f"  timed runs: {TEMP_DRAWS} draws x {TEMP_K} x {TEMP_CHAINS}, reps "
        f"{[round(x, 4) for x in dts]} s; tempered_replica_transitions_per_sec {rate:.1f}")
    say(f"  tempered_swap_accept {swaps}, tempered_cold_accept {cold:.4f}; replica accept "
        f"{[round(float(x), 4) for x in res.info['replica_accept_rate']]}")
    require(res.samples.shape == (TEMP_DRAWS, TEMP_COLLECT, TEMP_DIM), "tempered history shape")
    require(bool(torch.isfinite(res.samples).all()), "non-finite tempered draws")
    require(all(x > 0.1 for x in swaps), f"tempered swap rates {swaps}")
    require(0.75 < cold < 0.95, f"tempered cold accept {cold}")
    busy = device_busy_seconds(torch, lambda: run(60))
    say_busy("tempered row", busy, dt)
    return dict(rate=rate, swaps=swaps, cold=cold, wall=dt, busy=busy)


def phase_crossing(torch, targets, samplers, dev):
    """tests/test_tempered.py's crossing check on the card at 4,096 chains:
    the 4-D mixture with separation 10 (a 5-sigma barrier), every chain
    started in the left mode. tempered_run (6 rungs to beta 0.01, step 0.3,
    L = 16, 800 draws after 200 of burn-in; kernel 1b) must find both modes:
    right fraction 0.4-0.6 and |Var x0 - 26| < 3. Fused HMC from the same
    start (kernel 2, T = 8) must stay: right fraction < 0.15."""
    say(f"[5g] crossing check: 4-D mixture, separation 10, {CROSS_CHAINS} chains from the "
        f"left mode")
    t = targets.get_target("gaussian_mixture", dim=CROSS_DIM, separation=CROSS_SEP)
    init = torch.randn((CROSS_CHAINS, CROSS_DIM), generator=_gen(torch, dev, 80),
                       device=dev) * 0.3
    init[:, 0] -= CROSS_SEP / 2
    kw = dict(step_size=CROSS_STEP, num_steps=16, num_samples=CROSS_DRAWS, burn_in=CROSS_BURN,
              value_and_grad_fn=t.value_and_grad_fn)
    rh = samplers.hmc_run(_gen(torch, dev, 81), t.log_prob_fn, init, backend="fused", **kw)
    right_h = float((rh.samples[..., 0] > 0).float().mean())
    del rh
    rt = samplers.tempered_run(_gen(torch, dev, 81), t.log_prob_fn, init, n_temps=CROSS_K,
                               beta_min=CROSS_BETA_MIN, backend="auto", **kw)
    x0 = rt.samples[..., 0].reshape(-1).double()
    right, var = float((x0 > 0).double().mean()), float(x0.var())
    say(f"  fused HMC: right-mode fraction {right_h:.4f}; tempered: right-mode fraction "
        f"{right:.4f}, mean x0 {float(x0.mean()):.4f}, Var x0 {var:.4f} (exact 26), swaps "
        f"{[round(float(x), 4) for x in rt.info['swap_accept_rate']]}")
    require(right_h < 0.15, f"HMC crossed: right fraction {right_h}")
    require(0.4 < right < 0.6, f"tempered right fraction {right}")
    require(abs(var - 26.0) < 3.0, f"tempered Var x0 {var}")
    return dict(right=right, var=var, right_hmc=right_h)


def phase_ladder_tune(torch, targets, samplers, tuning, dev):
    """tune_ladder closing over the fused tempered_run on the tempered row's
    configuration: LADDER_ROUNDS rounds of LADDER_DRAWS-draw bursts, each
    continuing from the last one's replicas, the rung steps tuned jointly
    toward accept 0.65 (tests/test_ladder.py:141-170). Gate: the final
    deviation from 0.234 at most the initial one + 0.05."""
    say(f"[5h] ladder tune: {LADDER_ROUNDS} rounds of {LADDER_DRAWS}-draw bursts on the "
        f"tempered row's configuration")
    t = targets.get_target("gaussian_mixture", dim=TEMP_DIM)
    init = t.init_sampler(_gen(torch, dev, 90), TEMP_CHAINS)
    kw = _tempered_kw(t, samplers)
    rounds = [0]

    def burst(betas, steps, rep):
        rounds[0] += 1
        r = samplers.tempered_run(_gen(torch, dev, 90 + rounds[0]), t.log_prob_fn, init,
                                  step_size=torch.from_numpy(steps).to(dev),
                                  num_samples=LADDER_DRAWS, betas=torch.from_numpy(betas),
                                  init_replica_position=rep, collect_chains=1, **kw)
        return (r.info["swap_accept_rate"].cpu().numpy(), r.info["swap_attempts"].cpu().numpy(),
                r.info["replica_accept_rate"].cpu().numpy(), r.info["replica_final_positions"])

    t0 = time.perf_counter()
    betas, info = tuning.tune_ladder(burst, TEMP_K, beta_min_init=TEMP_BETA_MIN,
                                     n_rounds=LADDER_ROUNDS, step_size=TEMP_STEP,
                                     target_accept=0.65)
    say(f"  {time.perf_counter() - t0:.2f} s; deviation from 0.234: initial "
        f"{info['initial_deviation']:.4f}, final {info['final_deviation']:.4f}; betas "
        f"{[round(float(b), 4) for b in betas]}, steps "
        f"{[round(float(x), 4) for x in info['step_sizes']]}")
    require(info["final_deviation"] <= info["initial_deviation"] + 0.05,
            f"ladder deviation grew: {info['initial_deviation']} -> {info['final_deviation']}")
    return info


def _smc_kw(t):
    return dict(dim=SMC_DIM, step_size=SMC_STEP, base_scale=SMC_BASE_SCALE,
                value_and_grad_fn=t.value_and_grad_fn, move_backend="auto")


def phase_smc_row(torch, targets, samplers, dev):
    """bench.py's SMC row on the port: adaptive-schedule SMC from N(0, 6^2 I)
    to the 10-D mixture, 32,768 particles, eps 0.4, L = 8, 2 moves per stage,
    final_resample, move_backend "auto" (kernel 1c on the card); one warm
    run and SMC_REPS timed runs; smc_particle_leapfrogs_per_sec = P stages
    moves L / wall per rep (each rep's own stage count), the median; log Z,
    stages and the mode fraction of the last rep; one more run under the
    profiler for the device-busy share. Gates: |log Z| < 0.1, mode fraction
    0.4-0.6, |Var x0 - 7.25| < 0.5, and the warm run's seed run once more
    gives its log Z and particles bit for bit. Returns the row's numbers and the
    kernel-1c launches its runs made (stages x moves each)."""
    say("[5i] SMC row: 10-D mixture, 32,768 particles, adaptive schedule (kernel 1c)")
    t = targets.get_target("gaussian_mixture", dim=SMC_DIM)
    kw = dict(_smc_kw(t), n_particles=SMC_P, num_steps=SMC_L, move_steps=SMC_MOVES,
              final_resample=True)
    backend = samplers.smc.resolve_move_backend("auto", t.value_and_grad_fn, False, None, dev)
    require(backend == "fused", f"SMC move backend resolved to {backend}")
    stages = []

    def run(seed):
        r = samplers.smc_run(_gen(torch, dev, seed), t.log_prob_fn, **kw)
        stages.append(r.info["n_stages"])
        return r

    warm = run(60)
    torch.cuda.synchronize()
    rates, dts = [], []
    for rep in range(SMC_REPS):
        t0 = time.perf_counter()
        r = run(61 + rep)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        rates.append(SMC_P * stages[-1] * SMC_MOVES * SMC_L / dts[-1])
    rate = statistics.median(rates)
    x0 = r.particles[:, 0].double()
    mode, var, log_z = float((x0 > 0).double().mean()), float(x0.var()), float(r.log_Z)
    say(f"  reps (stages, s) {[(n, round(d, 4)) for n, d in zip(stages[1:], dts)]}; "
        f"smc_particle_leapfrogs_per_sec {rate:.1f}")
    say(f"  smc_log_z {log_z:+.5f}, smc_stages {stages[-1]}, smc_mode_fraction {mode:.4f}, "
        f"Var x0 {var:.4f} (exact 7.25), resamples {r.info['n_resamples']}, final step "
        f"{float(r.info['final_step_size']):.4f}")
    require(bool(torch.isfinite(r.particles).all()), "non-finite SMC particles")
    require(abs(log_z) < 0.1, f"SMC log Z {log_z}")
    require(0.4 < mode < 0.6, f"SMC mode fraction {mode}")
    require(abs(var - 7.25) < 0.5, f"SMC Var x0 {var}")
    out = dict(rate=rate, log_z=log_z, stages=stages[-1], mode=mode,
               wall=statistics.median(dts))
    again = run(60)
    same = torch.equal(warm.log_Z, again.log_Z) and torch.equal(warm.particles, again.particles)
    say(f"  the warm run's seed again: log Z {float(again.log_Z):+.8f} against "
        f"{float(warm.log_Z):+.8f}, particles {'equal' if same else 'differ'}")
    require(same, "two SMC runs with one seed differ")
    del warm, again
    out["busy"] = device_busy_seconds(torch, lambda: run(70))
    say_busy(f"SMC row ({stages[-1]} stages in the profiled run)", out["busy"], out["wall"])
    out["launches"] = SMC_MOVES * sum(stages)
    return out


def phase_smc_repeat(torch, targets, samplers, dev, reps=200, runs=3, seeds=range(60, 65)):
    """The SMC repeat probe (--smc-repeat), gating nothing. (1) One
    32,768-particle weight vector: its resampling CDF summed `reps` times by
    torch.cumsum and by samplers.smc.prefix_sum, and its logsumexp `reps`
    times; how many results differ from the first in any bit, and the host
    wall per call. (2) The SMC
    row's runs (its seeds 60-64) `runs` times each with each CDF; one line
    per run with log Z's bits (float.hex), each stage's beta and, for each
    resampling, a digest of the CDF's bits and one of the indices drawn from
    it, in order: lines that differ between runs or between two processes
    name the first op whose output changed. Counts the seeds whose runs in
    this process differ."""
    say("[5i'] SMC repeat probe: the resampling CDF by torch.cumsum and by prefix_sum")
    smc = samplers.smc
    lw = torch.randn(SMC_P, generator=_gen(torch, dev, 90), device=dev) * 3.0
    w = torch.exp(lw - torch.logsumexp(lw, 0))
    cdfs = {"torch.cumsum": lambda x: torch.cumsum(x, 0), "prefix_sum": smc.prefix_sum}
    for name, fn in list(cdfs.items()) + [("logsumexp", lambda x: torch.logsumexp(x, 0))]:
        first = fn(w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(w) for _ in range(reps)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        differ = sum(not torch.equal(out, first) for out in outs)
        say(f"  {name} of one {SMC_P}-particle weight vector, {reps} calls: {differ} differ "
            f"from the first; {ms:.4f} ms a call (host wall, calls back to back)")
    t = targets.get_target("gaussian_mixture", dim=SMC_DIM)
    kw = dict(_smc_kw(t), n_particles=SMC_P, num_steps=SMC_L, move_steps=SMC_MOVES,
              final_resample=True)
    trace = []

    def digest(x):
        bits = x.double().view(torch.int64)
        return int((bits * torch.arange(1, x.shape[0] + 1, device=x.device)).sum())

    def resample(generator, log_weights, u=None):
        idx = saved[1](generator, log_weights, u)
        trace.append(f"idx {digest(idx.double())}")
        return idx

    saved = (smc.prefix_sum, smc.systematic_resample)
    smc.systematic_resample = resample
    try:
        for name, fn in cdfs.items():
            def cdf(x, fn=fn):
                out = fn(x)
                trace.append(f"cdf {digest(out)}")
                return out
            smc.prefix_sum = cdf
            varied = []
            for seed in seeds:
                lines = set()
                for run in range(runs):
                    trace.clear()
                    r = samplers.smc_run(_gen(torch, dev, seed), t.log_prob_fn, **kw)
                    betas = [float(b).hex() for b in r.info["betas"][:r.info["n_stages"]]]
                    line = (f"log Z {float(r.log_Z).hex()}, stages {r.info['n_stages']}, betas "
                            f"{betas}, resamplings {trace}")
                    say(f"    {name} seed {seed} run {run}: {line}")
                    lines.add(line)
                if len(lines) > 1:
                    varied.append(seed)
            say(f"  {name}: seeds {list(seeds)}, {runs} runs each; seeds whose runs differ in "
                f"this process: {varied}")
    finally:
        smc.prefix_sum, smc.systematic_resample = saved


def phase_smc_move_pair(torch, targets, samplers, dev):
    """bench.py's move-dominated pair on the port: 65,536 particles, L = 16,
    the fixed 13-rung ladder linspace(0.08, 1, 13), 2 and 8 moves per stage,
    one warm run and MOVE_REPS reps each, the min wall of each;
    smc_move_dominated_leapfrogs_per_sec = P 13 8 L / wall at 8 moves."""
    say("[5j] SMC move-dominated pair: 65,536 particles, L = 16, 13 fixed rungs, 2 and 8 moves")
    t = targets.get_target("gaussian_mixture", dim=SMC_DIM)
    betas = torch.linspace(0.08, 1.0, MOVE_RUNGS, dtype=torch.float64)
    walls = {}
    for moves in (2, 8):
        kw = dict(_smc_kw(t), n_particles=MOVE_P, num_steps=MOVE_L, move_steps=moves,
                  betas=betas)
        samplers.smc_run(_gen(torch, dev, 70), t.log_prob_fn, **kw)
        torch.cuda.synchronize()
        dts = []
        for rep in range(MOVE_REPS):
            t0 = time.perf_counter()
            r = samplers.smc_run(_gen(torch, dev, 71 + rep), t.log_prob_fn, **kw)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        require(r.info["n_stages"] == MOVE_RUNGS, "fixed-ladder stage count")
        walls[moves] = min(dts)
        say(f"  {moves} moves: reps {[round(x, 4) for x in dts]} s, log Z "
            f"{float(r.log_Z):+.5f}")
    rate = MOVE_P * MOVE_RUNGS * 8 * MOVE_L / walls[8]
    say(f"  smc_move_dominated_leapfrogs_per_sec {rate:.1f}; smc_move_pair_ms moves2 "
        f"{walls[2] * 1e3:.3f}, moves8 {walls[8] * 1e3:.3f} ({walls[8] / walls[2]:.3f}x the "
        f"time for 4x the moves)")
    return dict(rate=rate, walls=walls)


def _hier_target(targets):
    return targets.get_target("hierarchical_logistic", dim=HIER_DIM, n_data=HIER_N_DATA)


def _mean_mcse(torch, diagnostics, samples, ess=None):
    """Per-coordinate (mean, MCSE = sd / sqrt(bulk ESS), sd) of a full
    history."""
    if ess is None:
        ess = diagnostics.ess_bulk_chunked(samples, chain_chunk=samples.shape[1], dim_chunk=4)
    x = samples.double()
    sd = x.std(dim=(0, 1))
    return x.mean(dim=(0, 1)), sd / torch.sqrt(ess.double()), sd


def _longest_run(torch, mask):
    """Longest stretch of consecutive True along axis 0 of a (N, ...) mask."""
    idx = torch.arange(mask.shape[0], device=mask.device).view(-1, *([1] * (mask.ndim - 1)))
    last_out = torch.cummax(torch.where(mask, -1, idx.expand_as(mask)), dim=0).values
    return int((idx - last_out).masked_fill(~mask, 0).max())


def _mean_z(a, b):
    """|mean_a - mean_b| over the combined MCSE, per coordinate."""
    return (a[0] - b[0]).abs() / (a[1] ** 2 + b[1] ** 2).sqrt()


def _compare_means(label, a, b):
    """Print and return the per-coordinate z of two runs' (mean, MCSE, sd)
    and their mean shift in a's posterior sd."""
    z = _mean_z(a, b)
    shift = (a[0] - b[0]).abs() / a[2]
    worst = int(z.argmax())
    say(f"  {label} means: max |diff| / combined MCSE {float(z.max()):.3f} at coordinate "
        f"{worst} ({float(a[0][worst]):.5f} / {float(b[0][worst]):.5f}), median "
        f"{float(z.median()):.3f}; largest shift {float(shift.max()):.4f} posterior sd; tau "
        f"{float(a[0][0]):.5f} / {float(b[0][0]):.5f} (MCSE {float(a[1][0]):.5f} / "
        f"{float(b[1][0]):.5f})")
    return z, shift


def phase_hier_row(torch, targets, samplers, tuning, diagnostics, dev):
    """Config 5 on the port (BASELINE.json configs[4]: the 100-D hierarchical
    logistic posterior, tune + sample + diagnostics): 8,192 chains from the
    target's init_sampler; run_adaptive_warmup("grahmc", diagonal metric,
    tanh schedule, L = 16, the JAX defaults otherwise: 2,700 windowed and
    8,050 gamma-tune transitions through kernel 1d); grahmc_run at the
    tuned step, gamma and metric, HIER_DRAWS draws keeping every chain's
    history (kernel 1d): chain-steps/s, min bulk-ESS/s, max split R-hat,
    and its two halves' means; then at 4,096 chains a HIER_MULTI_DRAWS-draw
    run through the multistep dispatch (kernel 2b); persistent NUTS with the
    learned metric, the step tuned by the NUTS row's dual averaging, a
    warm-up and HIER_NUTS_REPS timed runs of 192 draws x 64 slots (kernel
    4c), then the multinomial scheme (kernel 4a's data form), their means
    against GRAHMC's printed; rwmh_run at scale 2.38 / sqrt(D) x sqrt(mean
    learned variance), HIER_RWMH_DRAWS timed draws, then HIER_RWMH_KEEP
    draws thinned by RWMH_T (kernel 3a). Gates: GRAHMC accept 0.65 +-
    HIER_ACCEPT_TOL, R-hat <= HIER_RHAT_MAX, min bulk ESS >= HIER_ESS_MIN,
    finite draws; 2b's accept within 0.05 of the 8,192-chain run's; NUTS
    accept 0.65 +- 0.1; RWMH finite with accept in (0.01, 0.9); GRAHMC's
    and RWMH's posterior means within HIER_MCSE_Z combined MCSE (sd /
    sqrt(bulk ESS)) on every coordinate."""
    say(f"[5k] config 5: {HIER_DIM}-D hierarchical logistic posterior (n_data "
        f"{HIER_N_DATA}), {HIER_CHAINS} chains: warmup, gamma tune, GRAHMC, NUTS, RWMH "
        f"(kernels 1d, 2b, 4c, 3a)")
    t = _hier_target(targets)
    tanh = samplers.tanh_schedule
    init = t.init_sampler(_gen(torch, dev, 110), HIER_CHAINS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, inv_mass, pos, info = tuning.run_adaptive_warmup(
        "grahmc", t.log_prob_fn, None, init, _gen(torch, dev, 111), num_warmup=WARMUP_STEPS,
        learn_mass_matrix=True, backend="fused", num_steps=HIER_L, schedule_type="tanh",
        value_and_grad_fn=t.value_and_grad_fn)
    torch.cuda.synchronize()
    warmup_sec = time.perf_counter() - t0
    say(f"  hier_warmup_sec {warmup_sec:.4f} ({WARMUP_TRANSITIONS} warmup and "
        f"{TUNE_TRANSITIONS} gamma-tune transitions); tuned step {step:.6f}, gamma "
        f"{info['gamma']}, steepness {info['steepness']}; learned variance tau "
        f"{float(inv_mass[0]):.4f}, beta mean {float(inv_mass[1:].mean()):.5f}; last batch "
        f"accept {info['accept_trace'][-1]:.4f}")
    require(0.0 < step < 5.0 and bool(torch.isfinite(pos).all()), "config-5 warmup")

    kw = dict(step_size=step, num_steps=HIER_L, gamma=info["gamma"],
              steepness=info["steepness"], friction_schedule=tanh, inv_mass_matrix=inv_mass,
              value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = samplers.grahmc_run(_gen(torch, dev, 112), t.log_prob_fn, pos,
                              num_samples=HIER_DRAWS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    accept = float(res.accept_rate.mean())
    require(res.samples.shape == (HIER_DRAWS, HIER_CHAINS, HIER_DIM), "config-5 history shape")
    require(bool(torch.isfinite(res.samples).all()), "config-5 non-finite draws")
    t0 = time.perf_counter()
    ess = diagnostics.ess_bulk_chunked(res.samples, chain_chunk=HIER_CHAINS, dim_chunk=4)
    rhat = diagnostics.split_rhat_chunked(res.samples, chain_chunk=HIER_CHAINS, dim_chunk=4)
    torch.cuda.synchronize()
    diag_sec = time.perf_counter() - t0
    grahmc = _mean_mcse(torch, diagnostics, res.samples, ess)
    half = HIER_DRAWS // 2
    halves = [_mean_mcse(torch, diagnostics, h) for h in (res.samples[:half], res.samples[half:])]
    ess_min, rhat_max = float(ess.min()), float(rhat.max())
    rate = HIER_CHAINS * HIER_DRAWS / wall
    say(f"  GRAHMC: {HIER_DRAWS} draws x {HIER_CHAINS} chains in {wall:.4f} s, accept "
        f"{accept:.4f}; hier_grahmc_chain_steps_per_sec {rate:.1f}, hier_grahmc_ess_per_sec "
        f"{ess_min / wall:.1f} (min bulk-ESS {ess_min:.1f}, median {float(ess.median()):.1f}), "
        f"hier_grahmc_rhat_max {rhat_max:.5f} (diagnostics {diag_sec:.2f} s)")
    _compare_means("GRAHMC's first vs second half", *halves)
    require(abs(accept - TARGET_ACCEPT) <= HIER_ACCEPT_TOL, f"config-5 GRAHMC accept {accept}")
    require(rhat_max <= HIER_RHAT_MAX, f"config-5 R-hat {rhat_max}")
    require(ess_min >= HIER_ESS_MIN, f"config-5 min bulk ESS {ess_min}")
    del res

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi = samplers.grahmc_run(_gen(torch, dev, 113), t.log_prob_fn,
                                pos[:HIER_MULTI_CHAINS].contiguous(),
                                num_samples=HIER_MULTI_DRAWS, collect_chains=COLLECT, **kw)
    torch.cuda.synchronize()
    multi_wall = time.perf_counter() - t0
    acc_m = float(multi.accept_rate.mean())
    say(f"  {HIER_MULTI_CHAINS} chains, {HIER_MULTI_DRAWS} draws through the multistep dispatch "
        f"(kernel 2b, block-tiled) in {multi_wall:.4f} s (one run): accept {acc_m:.4f}")
    require(bool(torch.isfinite(multi.samples).all()), "config-5 multistep draws")
    require(abs(acc_m - accept) <= 0.05, f"config-5 multistep accept {acc_m} vs {accept}")
    del multi

    t0 = time.perf_counter()
    nuts_step, _ = _da_tune_nuts(torch, tuning, samplers, dev, t, HIER_CHAINS, init=pos,
                              inv_mass_matrix=inv_mass)
    say(f"  NUTS step {float(nuts_step):.6f} ({NUTS_TUNE_CALLS} runs of {NUTS_TUNE_SPS} slots, "
        f"{time.perf_counter() - t0:.2f} s)")
    nuts, nres = _nuts_timed(torch, samplers, diagnostics, dev, t, "config-5 NUTS", 114,
                             chains=HIER_CHAINS, reps=HIER_NUTS_REPS, init=pos,
                             step_size=nuts_step, inv_mass_matrix=inv_mass)
    say(f"  hier_nuts_useful_grads_per_sec {nuts['rate']:.1f}, hier_nuts_ess_per_sec "
        f"{nuts['ess_rate']:.1f}")
    # persistent NUTS's means are read, not gated: the JAX package's machine
    # shows the same shifts on this posterior (tests/test_torch_hierarchical.py)
    _compare_means("GRAHMC vs NUTS (endpoint scheme)", grahmc,
                   _mean_mcse(torch, diagnostics, nres.samples, nuts["ess"]))
    del nres
    require(abs(nuts["accept"] - TARGET_ACCEPT) < 0.1, f"config-5 NUTS accept {nuts['accept']}")
    mres = samplers.nuts_run_persistent(
        _gen(torch, dev, 116), t.log_prob_fn, pos, step_size=nuts_step,
        num_samples=NUTS_SAMPLES, steps_per_sample=NUTS_STEPS_PER_SAMPLE,
        inv_mass_matrix=inv_mass, value_and_grad_fn=t.value_and_grad_fn,
        proposal_scheme="multinomial")
    require(bool(torch.isfinite(mres.samples).all()), "config-5 NUTS-multinomial draws")
    say(f"  NUTS-multinomial: accept {float(torch.nanmean(mres.info['mean_accept_probs'])):.4f}, "
        f"mean tree depth {float(mres.info['mean_tree_depth'].mean()):.3f}")
    _compare_means("GRAHMC vs NUTS-multinomial", grahmc,
                   _mean_mcse(torch, diagnostics, mres.samples))
    del mres

    scale = 2.38 / HIER_DIM ** 0.5 * float(inv_mass.mean()) ** 0.5
    t0 = time.perf_counter()
    rres = samplers.rwmh_run(_gen(torch, dev, 115), t.log_prob_fn, pos,
                             num_samples=HIER_RWMH_DRAWS, scale=scale, collect_chains=COLLECT,
                             value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    torch.cuda.synchronize()
    r_wall = time.perf_counter() - t0
    r_acc = float(rres.accept_rate.mean())
    say(f"  RWMH: scale {scale:.5f}, {HIER_RWMH_DRAWS} draws x {HIER_CHAINS} chains in "
        f"{r_wall:.4f} s; hier_rwmh_chain_steps_per_sec "
        f"{HIER_CHAINS * HIER_RWMH_DRAWS / r_wall:.1f}, accept {r_acc:.4f}")
    require(bool(torch.isfinite(rres.samples).all()), "config-5 RWMH draws")
    require(0.01 < r_acc < 0.9, f"config-5 RWMH accept {r_acc}")
    # RWMH as the second witness of GRAHMC's means: kernel 3a evaluates the
    # log density only, so it shares neither 1d's gradient nor its integrator
    g = _gen(torch, dev, 117)
    q = rres.final_state.position
    kept = torch.empty((HIER_RWMH_KEEP, HIER_CHAINS, HIER_DIM), device=dev)
    for i in range(HIER_RWMH_KEEP):
        q = samplers.rwmh_run(g, t.log_prob_fn, q, num_samples=RWMH_T, scale=scale,
                              collect_chains=1, value_and_grad_fn=t.value_and_grad_fn,
                              backend="fused").final_state.position
        kept[i] = q
    del rres
    require(bool(torch.isfinite(kept).all()), "config-5 RWMH reference draws")
    rwmh = _mean_mcse(torch, diagnostics, kept)
    say(f"  RWMH reference: {HIER_RWMH_KEEP} draws x {HIER_CHAINS} chains, one every {RWMH_T} "
        f"transitions; min bulk-ESS {float((rwmh[2] / rwmh[1]).square().min()):.1f}")
    del kept
    z_rwmh, _ = _compare_means("GRAHMC vs RWMH", grahmc, rwmh)
    require(float(z_rwmh.max()) <= HIER_MCSE_Z,
            f"config-5 GRAHMC and RWMH means differ: max z {float(z_rwmh.max())}")
    return dict(step=step, gamma=info["gamma"], steepness=info["steepness"],
                inv_mass=inv_mass, pos=pos, warmup_sec=warmup_sec, rate=rate,
                ess_rate=ess_min / wall, rhat=rhat_max, accept=accept,
                nuts_step=float(nuts_step), nuts=nuts, rwmh_scale=scale,
                rwmh_rate=HIER_CHAINS * HIER_RWMH_DRAWS / r_wall)


def phase_parity_hier(torch, ft, fr, fn, tn, targets, row, dev):
    """Kernels 1d, 2b, 3a and 4c against their plain versions at config 5's
    shapes (8,192 x 100 x 256 data rows; 2b at 4,096 chains, T = 8; 3a T =
    32; 4c 16 iterations x W = 4), from the warmed positions at the tuned
    step, gamma, metric and NUTS step: injected draws, then Philox. No chain
    may split: accepts equal away from the MH borderline, q, lp and grad
    within 1e-4 (delta H within 2e-3); kernel 4c by window_agreement, every
    chain identical in its discrete state and within 1e-4 in its emitted and
    in-flight state. Then kernel 4's multinomial variant on the same data,
    which the row's multinomial runs launch, by the same rule with at most
    SPLIT_MAX of the chains split."""
    say("[3f] kernels 1d, 2b, 3a and 4c (the hierarchical posterior's data) vs plain versions")
    t = _hier_target(targets)
    info = t.value_and_grad_fn.kernel_info
    inv_mass = row["inv_mass"].float().contiguous()
    scalars = ft.kernel_scalars(row["step"], row["gamma"], row["steepness"], dev)
    tanh = ft.SCHEDULE_IDS["tanh"]
    g = _gen(torch, dev, 120)
    key = ft.PhiloxStream.from_generator(g, dev).key
    max_err = {}

    def momentum(shape):
        return torch.randn(shape, generator=g, device=dev) / torch.sqrt(inv_mass)

    def uniforms(shape):
        return torch.rand(shape, generator=g, device=dev).clamp_min(2.0 ** -25)

    q = row["pos"].float().contiguous()
    lp, grad = (x.contiguous() for x in t.value_and_grad_fn(q))
    args = (info, HIER_L, tanh, q, lp, grad, scalars, inv_mass)
    u = uniforms(HIER_CHAINS)
    err = 0.0
    for mode, rand, log_u in (
            ("injected", dict(p0=momentum((HIER_CHAINS, HIER_DIM)), u=u), torch.log(u)),
            ("philox", dict(key=key, call=7),
             torch.log(ft.philox_uniform(key, 7, 0, HIER_CHAINS, dev)))):
        kern = ft.grahmc_step_kernel(*args, **rand)
        plain = ft.grahmc_step_plain(*args, **rand)
        torch.cuda.synchronize()
        e, same = _compare(f"1d {mode}", torch, _fields(kern), _fields(plain), log_u,
                           flags=True)
        require(bool(same.all()), f"1d {mode}: {int((~same).sum())} chains split")
        ok = plain[4].abs() < 1000.0
        require(torch.allclose(kern[5][ok], plain[5][ok], rtol=1e-4, atol=1e-4),
                f"1d {mode}: proposal q differs")
        err = max(err, e)
    max_err["grahmc_step_kernel[data]"] = err

    n = HIER_MULTI_CHAINS
    margs = (info, HIER_L, tanh, MULTI_T, q[:n].contiguous(), lp[:n].contiguous(),
             grad[:n].contiguous(), scalars, inv_mass)
    u = uniforms((MULTI_T, n))
    err = 0.0
    for mode, rand, u_all in (
            ("injected", dict(p0=momentum((MULTI_T, n, HIER_DIM)), u=u), u),
            ("philox", dict(key=key, call=3), torch.stack(
                [ft.philox_uniform(key, 3, s, n, dev) for s in range(MULTI_T)]))):
        kern = ft.grahmc_multistep_kernel(*margs, **rand)
        plain = ft.grahmc_multistep_plain(*margs, **rand)
        torch.cuda.synchronize()
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for s in range(MULTI_T):
            e, alive = _compare(f"2b {mode} t={s}", torch, _fields(kern, s), _fields(plain, s),
                                torch.log(u_all[s]), alive, flags=True)
            err = max(err, e)
        require(bool(alive.all()), f"2b {mode}: {int((~alive).sum())} chains split")
        require(torch.allclose(kern[2], plain[2], rtol=1e-4, atol=1e-4), f"2b {mode}: final grad")
    max_err["grahmc_multistep_kernel[data]"] = err

    scale = fr.rwmh_scale(row["rwmh_scale"], dev)
    noise = torch.randn((RWMH_T, HIER_CHAINS, HIER_DIM), generator=g, device=dev)
    u = uniforms((RWMH_T, HIER_CHAINS))
    err = 0.0
    for mode, rand in (("injected", dict(noise=noise, u=u)), ("philox", dict(key=key, call=5))):
        rargs = (info, RWMH_T, q, lp, scale, COLLECT)
        kern = fr.rwmh_multistep_kernel(*rargs, **rand)
        plain = fr.rwmh_multistep_plain(*rargs, **rand)
        torch.cuda.synchronize()
        agree = (kern[2] == plain[2]).all(dim=0)
        hist = agree[:COLLECT]
        e, within = _close_on([(kern[0][agree], plain[0][agree]), (kern[1][agree], plain[1][agree]),
                               (kern[3][:, hist], plain[3][:, hist]),
                               (kern[4][:, hist], plain[4][:, hist])])
        _split_check(f"3a {mode}", agree, e, within, max_split=0)
        require(0.01 < float(kern[2].float().mean()) < 0.9, f"3a {mode}: accept")
        err = max(err, e)
    max_err["rwmh_multistep_kernel[data]"] = err

    nscalars = fn.nuts_scalars(row["nuts_step"], 1000.0, dev)
    nargs = (info, NUTS_ITERS, NUTS_W, NUTS_DEPTH)
    for multinomial, label, max_split in ((False, "4c", 0.0),
                                          (True, "4a's data form", SPLIT_MAX)):
        start = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial,
                                max_tree_depth=NUTS_DEPTH)
        warm = fn.nuts_window_kernel(*nargs, start, nscalars, inv_mass, key=key, call=0)
        shape = (NUTS_ITERS, HIER_CHAINS)
        n_slice = NUTS_ITERS * NUTS_W if multinomial else NUTS_ITERS
        draws = (torch.randn(shape + (HIER_DIM,), generator=g, device=dev),
                 torch.rand(shape, generator=g, device=dev) < 0.5,
                 torch.rand(shape, generator=g, device=dev) < 0.5,
                 torch.rand(shape, generator=g, device=dev), uniforms((n_slice, HIER_CHAINS)),
                 torch.rand(shape, generator=g, device=dev))
        name = NUTS_NAMES[fn.variant(warm, inv_mass, info)]
        err = 0.0
        for mode, rand in (("injected", dict(draws=draws)), ("philox", dict(key=key, call=1))):
            kern = fn.nuts_window_kernel(*nargs, _clone_state(warm), nscalars, inv_mass, **rand)
            plain = fn.nuts_window_plain(*nargs, _clone_state(warm), nscalars, inv_mass, **rand)
            torch.cuda.synchronize()
            same, emitted, in_flight, e = fn.window_agreement(kern, plain)
            kept = same & emitted & in_flight
            done = int((kern.transitions - warm.transitions).sum())
            say(f"  {label} {mode}: discrete state identical on {int(same.sum())}/{HIER_CHAINS} "
                f"chains, emitted and in-flight state within 1e-4 on {int(kept.sum())}; max |err| "
                f"{e:.3g}; {done} transitions")
            n_split = int((~kept).sum())
            require(n_split <= max_split * HIER_CHAINS,
                    f"{label} {mode}: {n_split} chains split or drifted")
            require(done > 0, f"{label} {mode}: no transition completed")
            err = max(err, e)
        max_err[name] = err
    return max_err


def phase_chees_row(torch, ft, targets, tuning, dev):
    """bench.py's ChEES row on the port (bench.py:527-579), at its own
    sizes: the 20-D non-centered funnel, 2,048 chains from N(0, 0.5^2),
    run_chees_warmup("hmc", 2,500 steps; eager transitions); chees_run
    (its "auto" backend: kernel 1 once per draw at the draw's quantized
    jitter level) at the tuned step, T and metric: a warm call at its
    default offset, then CHEES_REPS timed reps of 8,192 draws keeping 64
    chains at halton_offset 16,384 + 8,192 rep; the rate from the median;
    one rep profiled for the device-busy share. Gates: accept 0.651 +- 0.1,
    finite draws, no max_steps_cap_hit, the transformed draws' Var x0
    within 10% of 9 and the 19 z coordinates' variances within 0.1 of 1."""
    say(f"[5m] ChEES row: {CHEES_DIM}-D non-centered funnel, {CHEES_CHAINS} chains, "
        f"{CHEES_WARMUP}-step warmup, {CHEES_DRAWS} jittered draws (kernel 1)")
    t = targets.get_target("neals_funnel_noncentered", dim=CHEES_DIM)
    init = torch.randn((CHEES_CHAINS, CHEES_DIM), generator=_gen(torch, dev, 140),
                       device=dev) * 0.5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, inv_mass, pos, info = tuning.run_chees_warmup(
        "hmc", t.log_prob_fn, None, init, _gen(torch, dev, 141), num_warmup=CHEES_WARMUP,
        value_and_grad_fn=t.value_and_grad_fn)
    float(pos.sum())
    warmup_sec = time.perf_counter() - t0
    t_len, n_steps = info["trajectory_length"], info["num_steps"]
    say(f"  chees_warmup_seconds {warmup_sec:.4f}; chees_T {t_len:.4f}, chees_L {n_steps}, "
        f"step {step:.6f}, learned variance v {float(inv_mass[0]):.4f}, z mean "
        f"{float(inv_mass[1:].mean()):.4f}; last batch accept {info['accept_history'][-1]:.4f}; "
        f"max_steps_cap_hit {info['max_steps_cap_hit']}")
    require(not info["max_steps_cap_hit"], "ChEES warmup hit max_steps")
    require(bool(torch.isfinite(pos).all()) and 0.0 < step < 5.0, "ChEES warmup state")

    kw = dict(inv_mass_matrix=inv_mass, collect_chains=CHEES_COLLECT,
              value_and_grad_fn=t.value_and_grad_fn)

    def run(seed, **extra):
        return tuning.chees_run(_gen(torch, dev, seed), t.log_prob_fn, pos, step, t_len,
                                CHEES_DRAWS, **kw, **extra)
    res = run(142)                                  # warm call, offset 8,192
    float(res.final_state.position.sum())
    walls = []
    for rep in range(CHEES_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(143 + rep, halton_offset=16384 + 8192 * rep)
        float(res.final_state.position.sum())
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    rate = CHEES_CHAINS * CHEES_DRAWS / wall
    accept = float(res.accept_rate.mean())
    levels = res.info["jitter_level_steps"]
    ns = res.info["num_steps_per_draw"]
    weights = {n: float((ns == n).mean()) for n in levels}
    busy = device_busy_seconds(torch, lambda: run(150, halton_offset=16384))
    say(f"  chees_transitions_per_sec {rate:.1f} (reps {[round(w, 4) for w in walls]} s), "
        f"chees_accept {accept:.4f}; backend {res.info['jitter_backend']}, jitter levels' L "
        f"{levels} (shares {[round(weights[n], 4) for n in levels]}), mean L "
        f"{res.info['mean_num_steps']:.4f}")
    say_busy("ChEES sampling rep", busy, wall)
    x = targets.funnel_transform(res.samples.double())
    y = res.samples.double().reshape(-1, CHEES_DIM)
    var_x0 = float(x[..., 0].var())
    var_z = y[:, 1:].var(dim=0)
    say(f"  transformed draws: Var x0 {var_x0:.4f} (9), z variances "
        f"[{float(var_z.min()):.4f}, {float(var_z.max()):.4f}] (1); Var x1 "
        f"{float(x[..., 1].var()):.2f} (e^4.5 = 90.02)")
    require(res.info["jitter_backend"] == "fused", "ChEES sampling did not take kernel 1")
    require(res.samples.shape == (CHEES_DRAWS, CHEES_COLLECT, CHEES_DIM), "ChEES history shape")
    require(bool(torch.isfinite(res.samples).all()), "ChEES non-finite draws")
    require(abs(accept - CHEES_ACCEPT) < 0.1, f"ChEES accept {accept}")
    require(abs(var_x0 - 9.0) < 0.9, f"ChEES Var x0 {var_x0}")
    require(float((var_z - 1.0).abs().max()) < 0.1, "ChEES z variances")
    return dict(step=step, inv_mass=inv_mass, pos=pos, t_len=t_len, num_steps=n_steps,
                warmup_sec=warmup_sec, rate=rate, accept=accept, levels=levels,
                weights=weights, busy=busy, wall=wall)


def _da_tune_rwmh(torch, tuning, samplers, dev, t, pos):
    """RWMH's scale by dual averaging toward 0.234 (the JAX package's
    dual_averaging_tune_rwmh target) from 2.38 / sqrt(D): SWEEP_RWMH_TUNE
    fused runs of 32 transitions (one kernel 3 call each), each from the
    last one's state, no host read inside. Returns (scale, positions)."""
    da = tuning.da_init(2.38 / pos.shape[1] ** 0.5, device=dev)
    for i in range(SWEEP_RWMH_TUNE):
        res = samplers.rwmh_run(_gen(torch, dev, 200 + i), t.log_prob_fn, pos, num_samples=32,
                                scale=tuning.da_step_size(da), collect_chains=1,
                                value_and_grad_fn=t.value_and_grad_fn, backend="fused")
        pos = res.final_state.position
        da = tuning.da_update(da, res.accept_rate.mean(), SWEEP_RWMH_ACCEPT)
    return float(tuning.da_final_step_size(da)), pos


def phase_family_sweep(torch, targets, samplers, tuning, diagnostics, dev):
    """Each family of the ChEES slice at the canonical matrix's cell size
    (dim 10, 1,024 chains, 10,000 draws) under three samplers: GRAHMC
    (run_adaptive_warmup("grahmc", constant schedule, L = 16, diagonal
    metric, fused: kernel 1) then grahmc_run (kernel 2, T = 8); RWMH with a
    DA-tuned scale (kernel 3); persistent NUTS from GRAHMC's warmed
    positions with its learned diagonal metric, the step tuned as the NUTS
    row's is (kernel 4), 64 slots a draw (with the identity metric at the
    DA's first step, 0.1, the ill-conditioned Gaussian's trees outlast the
    tune's windows and the DA reads no acceptance). Gates: finite draws
    everywhere; split R-hat <= 1.05 and every posterior mean within 5
    combined MCSE of 10^6 exact-sampler draws, the run's MCSE both as sd
    / sqrt(bulk ESS) and from the spread of its chains' means, except the
    cells where the reference misses them (SWEEP_FINITE_ONLY, SWEEP_Z_MAX,
    SWEEP_CHAINS_Z). Each cell prints both z, the largest distance of a
    chain's mean from the exact mean, and its time in the tails (outside
    the exact draws' central 99.9%: the share against the exact 0.1%, the
    longest stretch of consecutive draws there, one chain's largest
    share). Returns {"rows": {family: {sampler: row}}, "states": {family:
    the target's kernel_info and each sampler's tuned state}} ([6i] times the
    kernels at them)."""
    say(f"[5n] family sweep: dim {SWEEP_DIM}, {SWEEP_CHAINS} chains, {SWEEP_DRAWS} draws; "
        f"GRAHMC (kernels 1, 2), RWMH (3), persistent NUTS (4)")
    out, states = {}, {}
    for i, family in enumerate(NEW_FAMILIES):
        t = targets.get_target(family, dim=SWEEP_DIM)
        g0 = _gen(torch, dev, 160 + i)
        init = (t.init_sampler(g0, SWEEP_CHAINS) if t.init_sampler is not None else
                torch.randn((SWEEP_CHAINS, SWEEP_DIM), generator=g0, device=dev) * 0.5)
        ref = targets.get_reference_sampler(family, SWEEP_DIM)(_gen(torch, dev, 170 + i),
                                                               SWEEP_REF_DRAWS)
        ref_stats = (ref.mean(0), ref.std(0) / SWEEP_REF_DRAWS ** 0.5, ref.std(0))
        tail_lo, tail_hi = torch.quantile(
            ref, torch.tensor([SWEEP_TAIL / 2, 1 - SWEEP_TAIL / 2], dtype=ref.dtype,
                              device=dev), dim=0)
        del ref
        rows = {}

        def grade(sampler, res, wall, note=""):
            samples = res.samples
            finite = bool(torch.isfinite(samples).all())
            require(finite, f"{family} {sampler}: non-finite draws")
            ess = diagnostics.ess_bulk_chunked(samples, chain_chunk=SWEEP_CHAINS, dim_chunk=4)
            rhat = float(diagnostics.split_rhat_chunked(samples, chain_chunk=SWEEP_CHAINS,
                                                        dim_chunk=4).max())
            # the grand mean's MCSE two ways: sd / sqrt(bulk ESS), and the
            # spread of the 1,024 independent chains' means (which sees a
            # chain that spends much of the run far out)
            x = samples.double()
            chain_means = x.mean(dim=0)
            zs_chains = _mean_z((chain_means.mean(dim=0),
                                 chain_means.std(dim=0) / SWEEP_CHAINS ** 0.5), ref_stats)
            zs_ess = _mean_z(_mean_mcse(torch, diagnostics, samples, ess), ref_stats)
            cell = (family, sampler)
            zs = zs_chains if cell in SWEEP_CHAINS_Z else torch.maximum(zs_chains, zs_ess)
            z, worst = float(zs.max()), int(zs.argmax())
            # time in the tails: outside the exact draws' central 99.9%
            tail = (x < tail_lo) | (x > tail_hi)
            del x
            share = float(tail.double().mean())
            stretch = _longest_run(torch, tail)
            chain_share = float(tail.double().mean(dim=(0, 2)).max())
            far = float((chain_means - ref_stats[0]).abs().max())
            div = float(res.info.get("divergence_rate", torch.zeros(())))
            accept = float(torch.nanmean(res.info["mean_accept_probs"])
                           if "mean_accept_probs" in res.info else res.accept_rate.mean())
            gate = ("finite draws only" if cell in SWEEP_FINITE_ONLY else
                    f"z <= {SWEEP_Z_MAX[cell]:.3f}" if cell in SWEEP_Z_MAX else
                    "z by the chains' spread" if cell in SWEEP_CHAINS_Z else "full")
            say(f"  {family} {sampler}{note}: {wall:.3f} s, accept {accept:.4f}, R-hat "
                f"{rhat:.4f}, min bulk-ESS {float(ess.min()):.1f}; means' max z "
                f"{float(zs_chains.max()):.3f} by the chains' spread, "
                f"{float(zs_ess.max()):.3f} by sd / sqrt(bulk ESS); gated z {z:.3f} at "
                f"coordinate {worst} ({float(chain_means.mean(dim=0)[worst]):.5f} vs "
                f"{float(ref_stats[0][worst]):.5f}); largest |chain mean - exact mean| "
                f"{far:.4f} (exact sd {float(ref_stats[2].max()):.4f}); tail share "
                f"{share / SWEEP_TAIL:.3f} x exact, longest stretch there {stretch} draws, one "
                f"chain's share there {chain_share:.5f}; divergence rate {div:.5f}; gates: {gate}")
            if cell not in SWEEP_FINITE_ONLY:
                require(rhat <= SWEEP_RHAT_MAX, f"{family} {sampler}: R-hat {rhat}")
                require(z <= SWEEP_Z_MAX.get(cell, SWEEP_MCSE_Z),
                        f"{family} {sampler}: means' z {z}")
            rows[sampler] = dict(rhat=rhat, z=z, z_chains=float(zs_chains.max()),
                                 z_ess=float(zs_ess.max()), div=div, accept=accept, wall=wall,
                                 ess=float(ess.min()), tail=share / SWEEP_TAIL, stretch=stretch,
                                 gate=gate)

        t0 = time.perf_counter()
        step, inv_mass, pos, info = tuning.run_adaptive_warmup(
            "grahmc", t.log_prob_fn, None, init, _gen(torch, dev, 161 + i), num_warmup=WARMUP_STEPS,
            learn_mass_matrix=True, backend="fused", num_steps=SWEEP_L, schedule_type="constant",
            value_and_grad_fn=t.value_and_grad_fn)
        res = samplers.grahmc_run(_gen(torch, dev, 162 + i), t.log_prob_fn, pos, step, SWEEP_L,
                                  info["gamma"], info["steepness"], SWEEP_DRAWS,
                                  inv_mass_matrix=inv_mass,
                                  friction_schedule=samplers.constant_schedule,
                                  value_and_grad_fn=t.value_and_grad_fn, backend="fused")
        torch.cuda.synchronize()
        grade("grahmc", res, time.perf_counter() - t0)
        del res

        t0 = time.perf_counter()
        scale, rpos = _da_tune_rwmh(torch, tuning, samplers, dev, t, init)
        res = samplers.rwmh_run(_gen(torch, dev, 163 + i), t.log_prob_fn, rpos,
                                num_samples=SWEEP_DRAWS, scale=scale,
                                value_and_grad_fn=t.value_and_grad_fn, backend="fused")
        torch.cuda.synchronize()
        grade("rwmh", res, time.perf_counter() - t0)
        del res

        t0 = time.perf_counter()
        nstep, npos = _da_tune_nuts(torch, tuning, samplers, dev, t, SWEEP_CHAINS,
                                    init=pos, inv_mass_matrix=inv_mass)
        res = samplers.nuts_run_persistent(
            _gen(torch, dev, 164 + i), t.log_prob_fn, npos, step_size=nstep,
            num_samples=SWEEP_DRAWS, steps_per_sample=NUTS_STEPS_PER_SAMPLE,
            inv_mass_matrix=inv_mass, value_and_grad_fn=t.value_and_grad_fn)
        torch.cuda.synchronize()
        grade("nuts", res, time.perf_counter() - t0,
              f" (step {float(nstep):.5f}, inverse metric [{float(inv_mass.min()):.4f}, "
              f"{float(inv_mass.max()):.4f}])")
        del res
        out[family] = rows
        states[family] = {"info": t.value_and_grad_fn.kernel_info,
                          "grahmc": (step, inv_mass, pos, info), "rwmh": (scale, None, rpos, None),
                          "nuts": (nstep, inv_mass, npos, None)}
    return {"rows": out, "states": states}


def _runner_verdict(row):
    return ("PASS" if row.get("quality_pass") else "USABLE" if row.get("usable") else "FAIL")


def phase_runner_cell(torch, counts):
    """run_benchmarks_torch.py's main() on the canonical matrix's
    non-centered-funnel cell (RUNNER_ARGS: GRAHMC-constant, persistent NUTS,
    RWMH at dim 10, 1,024 chains, 2,500 warmup, 10,000 draws), three times:
    into a new directory; again into it (the warmup cache on and resume by
    signature: nothing may run, the CSV and JSON stay byte-equal); and with
    --no-warmup-cache into another (the same tuned steps and the same draws'
    sha256 as the first: the card repeats itself). GRAHMC's row must be
    usable and pass quality, as the JAX package's row in RUNNER_REFERENCE
    does; the others' verdicts are printed beside the JAX package's. Each
    row's draws are hashed where the runner's _sample returns them, and the
    RWMH tuner's DA iterations counted where the runner calls it (its
    kernel-3 launches depend on when it converges). `counts` reads the
    kernels' launch counts. Returns {"expected": launches by kernel, "rows":
    the first run's rows, "wall": seconds}."""
    import hashlib
    import shutil
    import tempfile

    import run_benchmarks_torch as cli
    from mcmc_tpu_torch.benchmark import runner as R

    say(f"[5r] run_benchmarks_torch.py {' '.join(RUNNER_ARGS)}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), RUNNER_REFERENCE)) as f:
        reference = {r["sampler"]: r for r in json.load(f)
                     if r["target"] == RUNNER_TARGET and r.get("mass_matrix_learned") is True
                     and r.get("schedule") in (None, "constant")}
    digests, tunes = {}, []
    real_sample, real_tune = R._sample, R.dual_averaging_tune_rwmh

    def sample(sampler, *a, **k):
        res = real_sample(sampler, *a, **k)
        digests[sampler] = hashlib.sha256(
            res.samples.contiguous().cpu().numpy().tobytes()).hexdigest()
        return res

    def tune(*a, **k):
        scale, hist = real_tune(*a, **k)
        tunes.append(len(hist["scale_history"]))
        return scale, hist

    root = tempfile.mkdtemp(prefix="runner_cell_")
    runs = {}
    t0 = time.perf_counter()
    R._sample, R.dual_averaging_tune_rwmh = sample, tune
    try:
        for label, out_dir, extra in (("first", "run", ()), ("second", "run", ()),
                                      ("no-cache", "fresh", ("--no-warmup-cache",))):
            digests.clear()
            out = os.path.join(root, out_dir)
            before = counts()
            t = time.perf_counter()
            rows = cli.main([*RUNNER_ARGS, *extra, "--output-dir", out])
            after = counts()
            runs[label] = {
                "rows": {r["sampler"]: r for r in rows}, "digests": dict(digests),
                "wall": time.perf_counter() - t,
                "launches": sum(after.values()) - sum(before.values()),
                "files": {name: open(os.path.join(out, name), "rb").read()
                          for name in ("benchmark_results.csv", "benchmark_results.json")}}
            say(f"  [5r] {label} run: {runs[label]['wall']:.1f} s, "
                f"{runs[label]['launches']} kernel launches")
    finally:
        R._sample, R.dual_averaging_tune_rwmh = real_sample, real_tune
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0

    first, second, fresh = runs["first"], runs["second"], runs["no-cache"]
    for sampler, row in first["rows"].items():
        ref = reference[sampler]
        require(row.get("error") is None, f"[5r] {sampler}: {row.get('error')}")
        say(f"  [5r] {sampler}: {_runner_verdict(row)} (R-hat {row['rhat_max']:.4f}, bulk/tail "
            f"ESS {row['ess_bulk_min']:.0f}/{row['ess_tail_min']:.0f}, z {row['z_score_max']:.3f} "
            f"of {row['z_score_threshold']:.3f}, divergences {row['divergence_rate']:.5f}, "
            f"accept {row['accept_rate']:.4f}, W2 {row['sliced_w2']:.4f}, "
            f"transformed W2 {row['sliced_w2_transformed']:.4f}; warmup "
            f"{row['warmup_time']:.3f} s, sampling {row['sample_time']:.3f} s, "
            f"n_gradients {row['n_gradients']}); the JAX package's row: {_runner_verdict(ref)} "
            f"(R-hat {ref['rhat_max']:.4f}, bulk/tail ESS {ref['ess_bulk_min']:.0f}/"
            f"{ref['ess_tail_min']:.0f}, z {ref['z_score_max']:.3f}, W2 {ref['sliced_w2']:.4f})")
    g = first["rows"]["grahmc"]
    require(g["usable"] and g["quality_pass"] and reference["grahmc"]["quality_pass"],
            f"[5r] GRAHMC-constant: usable {g['usable']}, quality {g['quality_pass']} "
            f"(R-hat {g['rhat_max']}, z {g['z_score_max']}); the JAX package's row passes")
    require(second["launches"] == 0 and not second["digests"]
            and second["files"] == first["files"],
            f"[5r] the second run re-ran {sorted(second['digests'])}, "
            f"{second['launches']} launches")
    require(fresh["digests"] == first["digests"] and len(first["digests"]) == 3,
            f"[5r] draws' sha256 {fresh['digests']} after {first['digests']}")
    for sampler, row in first["rows"].items():
        step = "scale" if sampler == "rwmh" else "step_size"
        require(fresh["rows"][sampler][step] == row[step],
                f"[5r] {sampler}'s tuned {step}: {fresh['rows'][sampler][step]} vs {row[step]}")
    say(f"  [5r] second run: nothing re-ran, CSV and JSON byte-equal; no-cache run: the same "
        f"tuned steps and draws ({', '.join(f'{s} {d[:12]}' for s, d in first['digests'].items())})")
    require(len(tunes) == 2, f"[5r] {len(tunes)} RWMH tunes")
    per_run = {"grahmc_step_kernel": WARMUP_TRANSITIONS + TUNE_TRANSITIONS,
               "grahmc_multistep_kernel": SWEEP_DRAWS // SWEEP_MULTI_T,
               "nuts_window_kernel": WARMUP_TRANSITIONS + SWEEP_DRAWS}
    expected = {name: 2 * n for name, n in per_run.items()}
    expected["rwmh_multistep_kernel"] = sum(
        n * (100 // RUNNER_TUNE_T) + SWEEP_DRAWS // SWEEP_RWMH_T for n in tunes)
    say(f"  [5r] phase wall {wall:.1f} s (runs {first['wall']:.1f}, {second['wall']:.1f}, "
        f"{fresh['wall']:.1f} s); RWMH DA iterations {tunes}")
    return {"expected": expected, "rows": first["rows"], "wall": wall}


def _occupancy(torch, info, x):
    """The family's mode shares of draws x (draws, chains, dim), from the
    target's kernel_info: the bimodal funnel's share with v > 0; the L1
    shells' share on each shell (nearest |x - c_k|_1 - r_k, the radii from
    device_shells, the nested target's centres by the plain version's rule:
    centre k > 0 at +-mu_norm on axis (k - 1) // 2 % dim); overall, and the
    first mode's least and largest share in one chain. None for a unimodal
    target."""
    from mcmc_tpu_torch.ops.padded_targets import device_shells
    family = info["family"]
    if family == "multimodal_funnel_2d":
        mode = (x[..., 0] > 0).double()[..., None]
    elif family in ("concentric_l1_balls", "nested_l1_balls"):
        radii = device_shells(info)
        dim = x.shape[-1]
        centres = torch.zeros((len(radii), dim), dtype=x.dtype, device=x.device)
        if family == "nested_l1_balls":
            mu = float(info["params"]["mu_norm"])
            for k in range(1, len(radii)):
                centres[k, (k - 1) // 2 % dim] = mu if (k - 1) % 2 == 0 else -mu
        which = torch.zeros(x.shape[:2], dtype=torch.long, device=x.device)
        best = None
        for k, r in enumerate(radii):
            dist = ((x - centres[k]).abs().sum(-1) - r).abs()
            which = which if best is None else torch.where(dist < best, k, which)
            best = dist if best is None else torch.minimum(best, dist)
        mode = torch.nn.functional.one_hot(which, len(radii)).double()
    else:
        return None
    per_chain = mode.mean(dim=0)
    return ([round(float(v), 4) for v in mode.mean(dim=(0, 1))], float(per_chain[:, 0].min()),
            float(per_chain[:, 0].max()))


def _rahmc_reference(torch, targets, name, dim, dev):
    """(mean, MCSE) of a cell's reference, or None: 10^6 exact draws of the
    bimodal funnel, 0 for the L1 shells (symmetric), the JAX package's
    shipped long-NUTS draws for the 20-D Rosenbrock (read as data through
    the port's loader; 32 chains thinned by 4, rows draw-major: their MCSE
    from bulk ESS), none for the 10-D Rosenbrock."""
    from mcmc_tpu_torch.diagnostics import ess_bulk_chunked
    from mcmc_tpu_torch.targets.rosenbrock_reference import load_rosenbrock_reference
    if name == "rosenbrock":
        if dim != 20:
            return None
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ROSENBROCK_20D_REF)
        draws = load_rosenbrock_reference(20, path=path)
        n = draws.shape[0] // 32 * 32
        x = draws[:n].to(dev, torch.float64).reshape(-1, 32, dim)
        ess = ess_bulk_chunked(x, chain_chunk=32, dim_chunk=4)
        return x.mean(dim=(0, 1)), x.std(dim=(0, 1)) / torch.sqrt(ess.double())
    if name == "multimodal_funnel_2d":
        x = targets.get_reference_sampler(name)(_gen(torch, dev, 180), SWEEP_REF_DRAWS)
        return x.mean(0), x.std(0) / SWEEP_REF_DRAWS ** 0.5
    zero = torch.zeros(dim, dtype=torch.float64, device=dev)
    return zero, zero


def phase_rahmc_cells(torch, targets, samplers, tuning, diagnostics, dev, cell):
    """One cell of RAHMC_CELLS [5o] (the docstring of the constants says
    the protocol and the gates): every sampler of the cell through the
    library's entry points, graded by split R-hat, the means' z against the
    cell's reference by the chains' spread and by sd / sqrt(bulk ESS), the
    largest |chain mean - reference mean|, the mode occupancy; finite draws
    everywhere, RAHMC_GATES where the witness passes. Returns {"rows":
    {sampler: readings}, "expected": each kernel's launches by the protocol
    (the RWMH tune's from its iterations), "state": {sampler: (step, metric,
    positions)} for the timing phase}."""
    name, dim, which, metric, schedule, n_steps = RAHMC_CELLS[cell]
    t = targets.get_target(name, dim=dim)
    seed = 300 + 10 * list(RAHMC_CELLS).index(cell)
    init = t.init_sampler(_gen(torch, dev, seed), RAHMC_CHAINS)
    ref = _rahmc_reference(torch, targets, name, dim, dev)
    dense = metric == "dense"
    rows, state, expected = {}, {}, {}

    def add(kernel, n):
        expected[kernel] = expected.get(kernel, 0) + n

    def grade(sampler, res, wall, note):
        samples = res.samples
        require(bool(torch.isfinite(samples).all()), f"{cell} {sampler}: non-finite draws")
        ess = diagnostics.ess_bulk_chunked(samples, chain_chunk=RAHMC_CHAINS, dim_chunk=4)
        rhat = float(diagnostics.split_rhat_chunked(samples, chain_chunk=RAHMC_CHAINS,
                                                    dim_chunk=4).max())
        x = samples.double()
        chain_means = x.mean(dim=0)
        gates = RAHMC_GATES.get((cell, sampler), ())
        line = (f"  {cell} {sampler}{note}: {wall:.3f} s, R-hat {rhat:.4f}, min bulk-ESS "
                f"{float(ess.min()):.1f}")
        row = dict(rhat=rhat, wall=wall, ess=float(ess.min()), gates=gates)
        if ref is not None:
            z_chains = float(_mean_z((chain_means.mean(dim=0),
                                      chain_means.std(dim=0) / RAHMC_CHAINS ** 0.5), ref).max())
            z_ess = float(_mean_z(_mean_mcse(torch, diagnostics, samples, ess), ref).max())
            far = float((chain_means - ref[0]).abs().max())
            line += (f"; means' max z {z_chains:.3f} by the chains' spread, {z_ess:.3f} by sd / "
                     f"sqrt(bulk ESS); largest |chain mean - reference| {far:.4f}")
            row.update(z_chains=z_chains, z_ess=z_ess, far=far)
        occ = _occupancy(torch, t.value_and_grad_fn.kernel_info, x)
        if occ is not None:
            line += (f"; mode shares {occ[0]}, one chain's first-mode share "
                     f"{occ[1]:.4f}..{occ[2]:.4f}")
            row["modes"] = occ
        say(line + f"; gates: {', '.join(gates) or 'finite draws only'}")
        if "rhat" in gates:
            require(rhat <= SWEEP_RHAT_MAX, f"{cell} {sampler}: R-hat {rhat}")
        if "z" in gates:
            require(max(row["z_chains"], row["z_ess"]) <= SWEEP_MCSE_Z,
                    f"{cell} {sampler}: means' z {row['z_chains']}, {row['z_ess']}")
        rows[sampler] = row

    for k, sampler in enumerate(which):
        gen = _gen(torch, dev, seed + 1 + k)
        t0 = time.perf_counter()
        if sampler == "grahmc":
            step, inv_mass, pos, info = tuning.run_adaptive_warmup(
                "grahmc", t.log_prob_fn, None, init, gen, num_warmup=WARMUP_STEPS,
                learn_mass_matrix=metric, backend="fused", num_steps=n_steps,
                schedule_type=schedule, gamma=1.0,
                steepness=samplers.default_steepness(schedule),
                value_and_grad_fn=t.value_and_grad_fn)
            res = samplers.grahmc_run(gen, t.log_prob_fn, pos, step, n_steps, info["gamma"],
                                      info["steepness"], RAHMC_DRAWS, inv_mass_matrix=inv_mass,
                                      friction_schedule=samplers.get_friction_schedule(schedule),
                                      value_and_grad_fn=t.value_and_grad_fn, backend="fused")
            v = "[dense]" if dense else ""
            add(f"grahmc_step_kernel{v}", WARMUP_TRANSITIONS + TUNE_TRANSITIONS)
            add(f"grahmc_multistep_kernel{v}", RAHMC_DRAWS // MULTI_T)
            note = f" (step {step:.5f}, gamma {info['gamma']:.4f})"
            state[sampler] = (step, inv_mass, pos, info)
        elif sampler == "rwmh":
            scale, hist = tuning.dual_averaging_tune_rwmh(
                gen, t.log_prob_fn, init, max_iter=1000, value_and_grad_fn=t.value_and_grad_fn)
            res = samplers.rwmh_run(gen, t.log_prob_fn, init, RAHMC_DRAWS, scale,
                                    value_and_grad_fn=t.value_and_grad_fn, backend="fused")
            add("rwmh_multistep_kernel", len(hist["step_size_history"]) * 100 // RAHMC_TUNE_T
                + RAHMC_DRAWS // RAHMC_RWMH_T)
            note = f" (scale {scale:.5f}, {hist['converged_iter']} DA iterations)"
            state[sampler] = (scale, None, init, None)
        else:
            step, inv_mass, pos, info = tuning.run_adaptive_warmup(
                "nuts", t.log_prob_fn, None, init, gen, num_warmup=WARMUP_STEPS,
                learn_mass_matrix=metric, backend="persistent", max_tree_depth=15,
                nuts_proposal="endpoint", value_and_grad_fn=t.value_and_grad_fn)
            res = samplers.nuts_run_persistent(
                gen, t.log_prob_fn, pos, step, RAHMC_DRAWS,
                steps_per_sample=NUTS_STEPS_PER_SAMPLE, inv_mass_matrix=inv_mass,
                max_tree_depth=10, value_and_grad_fn=t.value_and_grad_fn)
            add("nuts_window_kernel[dense]" if dense else "nuts_window_kernel",
                WARMUP_TRANSITIONS + RAHMC_DRAWS)
            note = (f" (step {step:.5f}, accept "
                    f"{float(torch.nanmean(res.info['mean_accept_probs'])):.4f})")
            state[sampler] = (step, inv_mass, pos, info)
        torch.cuda.synchronize()
        grade(sampler, res, time.perf_counter() - t0, note)
        del res
    return {"rows": rows, "expected": expected, "state": state, "family": t.family,
            "info": t.value_and_grad_fn.kernel_info}


def _tail_stats(torch, x, lo, hi):
    """(share of draws outside [lo, hi] per coordinate, the longest stretch
    of consecutive draws a chain coordinate spent there)."""
    tail = (x < lo) | (x > hi)
    return float(tail.double().mean()), _longest_run(torch, tail)


def phase_classic_nuts(torch, targets, samplers, tuning, diagnostics, dev):
    """Classic NUTS (samplers.nuts, plain batched PyTorch: no kernel) on
    the card [5p]: the 10-D standard normal and Student-t(3), 1,024 chains,
    run_adaptive_warmup("nuts") over CLASSIC_WARMUP at depth 10, then
    nuts_run for CLASSIC_DRAWS draws. Gates on the standard normal: finite,
    R-hat <= 1.05, means within 5 MCSE of 0 (both MCSEs). Prints the
    seconds per transition, the mean tree depth and, on Student-t, the
    share of draws outside the exact central 99.9% against the exact 0.1%
    and the longest stretch a chain coordinate spent there, beside [5n]'s
    persistent-NUTS reading."""
    say(f"[5p] classic NUTS: dim {CLASSIC_DIM}, {CLASSIC_CHAINS} chains, depth {CLASSIC_DEPTH}, "
        f"{sum(CLASSIC_WARMUP['adaptation_windows']) + CLASSIC_WARMUP['exploration_steps'] + CLASSIC_WARMUP['cooldown_steps']}"
        f"-step warmup, {CLASSIC_DRAWS} draws")
    out = {}
    for k, family in enumerate(("standard_normal", "student_t")):
        t = targets.get_target(family, dim=CLASSIC_DIM)
        gen = _gen(torch, dev, 400 + k)
        init = torch.randn((CLASSIC_CHAINS, CLASSIC_DIM), generator=gen, device=dev) * 0.5
        t0 = time.perf_counter()
        step, inv_mass, pos, _ = tuning.run_adaptive_warmup(
            "nuts", t.log_prob_fn, None, init, gen, max_tree_depth=CLASSIC_DEPTH,
            value_and_grad_fn=t.value_and_grad_fn, **CLASSIC_WARMUP)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = samplers.nuts_run(gen, t.log_prob_fn, pos, step, CLASSIC_DRAWS,
                                inv_mass_matrix=inv_mass, max_tree_depth=CLASSIC_DEPTH,
                                value_and_grad_fn=t.value_and_grad_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        samples = res.samples
        require(bool(torch.isfinite(samples).all()), f"classic NUTS {family}: non-finite draws")
        rhat = float(diagnostics.split_rhat(samples).max())
        ess = diagnostics.ess_bulk(samples)
        x = samples.double()
        chain_means = x.mean(dim=0)
        exact = targets.get_reference_sampler(family, CLASSIC_DIM)(_gen(torch, dev, 410 + k),
                                                                  SWEEP_REF_DRAWS)
        ref = (exact.mean(0), exact.std(0) / SWEEP_REF_DRAWS ** 0.5)
        z_chains = float(_mean_z((chain_means.mean(dim=0),
                                  chain_means.std(dim=0) / CLASSIC_CHAINS ** 0.5), ref).max())
        z_ess = float(_mean_z(_mean_mcse(torch, diagnostics, samples, ess), ref).max())
        lo, hi = torch.quantile(exact[:200_000], torch.tensor(
            [SWEEP_TAIL / 2, 1 - SWEEP_TAIL / 2], dtype=exact.dtype, device=dev), dim=0)
        share, stretch = _tail_stats(torch, x, lo, hi)
        depth = float(res.info["tree_depths"].double().mean())
        per = wall / CLASSIC_DRAWS
        say(f"  {family}: warmup {warm:.2f} s (step {step:.5f}), {CLASSIC_DRAWS} draws in "
            f"{wall:.2f} s = {per * 1e3:.2f} ms per transition of all {CLASSIC_CHAINS} chains "
            f"(mean tree depth {depth:.3f}, max {int(res.info['tree_depths'].max())}); R-hat "
            f"{rhat:.4f}, min bulk-ESS {float(ess.min()):.1f}; means' max z {z_chains:.3f} by "
            f"the chains' spread, {z_ess:.3f} by bulk ESS; tail share {share / SWEEP_TAIL:.3f} "
            f"x exact, longest stretch there {stretch} draws; divergences "
            f"{int(res.info['total_divergences'])}")
        if family == "standard_normal":
            require(rhat <= SWEEP_RHAT_MAX, f"classic NUTS: R-hat {rhat}")
            require(max(z_chains, z_ess) <= SWEEP_MCSE_Z,
                    f"classic NUTS: means' z {z_chains}, {z_ess}")
        out[family] = dict(rhat=rhat, z_chains=z_chains, z_ess=z_ess, tail=share / SWEEP_TAIL,
                           stretch=stretch, sec_per_transition=per, depth=depth, warmup=warm)
    return out


def phase_rosenbrock_reference(torch, targets, dev):
    """generate_rosenbrock_reference at a cut [5q] (REF_*: dim 10, 32
    chains, the classic warmup of [5p], depth 10, 32 draws per chain after
    thinning)
    into a temporary directory: its seconds and split R-hat, and the cache
    read back through load_rosenbrock_reference."""
    import tempfile

    from mcmc_tpu_torch.diagnostics import split_rhat
    from mcmc_tpu_torch.targets import rosenbrock_reference as rr
    say(f"[5q] generate_rosenbrock_reference: dim {REF_DIM}, {REF_CHAINS} chains, "
        f"{REF_DRAWS} draws thinned by {REF_THIN}")
    warm = {k: v for k, v in CLASSIC_WARMUP.items() if k != "update_freq"}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"rosenbrock_{REF_DIM}d.npy")
        t0 = time.perf_counter()
        flat = rr.generate_rosenbrock_reference(REF_DIM, n_samples=REF_DRAWS,
                                                n_chains=REF_CHAINS, thin=REF_THIN, path=path,
                                                device=dev, max_tree_depth=REF_DEPTH,
                                                update_freq=CLASSIC_WARMUP["update_freq"], **warm)
        seconds = time.perf_counter() - t0
        back = rr.load_rosenbrock_reference(REF_DIM, path=path)
    require(back.shape == (REF_DRAWS, REF_DIM) and bool(torch.isfinite(back).all()),
            "generate_rosenbrock_reference: bad cache")
    x = back.double().reshape(-1, REF_CHAINS, REF_DIM)
    rhat = float(split_rhat(x).max())
    say(f"  {seconds:.2f} s; split R-hat of the cached draws {rhat:.4f}; means "
        f"{[round(float(m), 3) for m in x.mean(dim=(0, 1))]}")
    return {"seconds": seconds, "rhat": rhat}


def _us_per_leapfrog(ms, leapfrogs, chains):
    """A window's time per executed chain-leapfrog: what one chain's
    leapfrog costs, the chains running side by side."""
    return f"{1000.0 * ms / max(leapfrogs / chains, 1e-9):.3f} us per chain-leapfrog"


def _time_family(torch, ft, fr, fn, tn, dev, key, family, info, state, dim, metric, schedule,
                 n_steps, rwmh_t, chains, reps, burst, plain_burst, times, measured, shapes,
                 log=""):
    """Time each kernel a cell of `family` launched at the cell's shape,
    kernel against plain version (Philox mode, _interleaved): kernel 1 or
    1a and kernel 2 or 2a (T = 8) from GRAHMC's warmed positions at its
    tuned step, friction and metric; kernel 3 (T = rwmh_t, every chain's
    history) from its positions at the tuned scale; kernel 4 or 4b (16
    iterations x W = 4) from NUTS's warmed positions at its tuned step and
    metric, two windows in, its executed leapfrogs counted for the bound.
    Fills times {pair: (kernel ms, plain ms)}, measured {pair: {"leapfrogs":
    per call}} and shapes {pair: (chains, dim, L, T)}; a pair is "kernel
    (family)". Kernel 2's and 2a's lines add its ns a chain-substep and the
    ptxas lines of its instances (from the build `log`)."""
    from mcmc_tpu_torch.ops.padded_targets import device_lp
    vag = ft.device_vag(info)
    runs = []
    step, inv_mass, pos, info_g = state["grahmc"]
    q = pos.float().contiguous()
    lp, grad = (x.contiguous() for x in vag(q))
    invm, l_inv = ft.kernel_metric(inv_mass.to(dev))
    v = "[dense]" if metric == "dense" else ""
    scalars = ft.kernel_scalars(step, info_g["gamma"], info_g["steepness"], dev)
    sched = ft.SCHEDULE_IDS[schedule]
    a1 = (info, n_steps, sched, q, lp, grad, scalars, invm)
    runs.append((f"grahmc_step_kernel{v}", (n_steps, 1),
                 lambda a=a1: ft.grahmc_step_kernel(*a, key=key, call=0, l_inv=l_inv),
                 lambda a=a1: ft.grahmc_step_plain(*a, key=key, call=0, l_inv=l_inv)))
    a2 = (info, n_steps, sched, MULTI_T, q, lp, grad, scalars, invm)
    runs.append((f"grahmc_multistep_kernel{v}", (n_steps, MULTI_T),
                 lambda a=a2: ft.grahmc_multistep_kernel(*a, key=key, call=0, l_inv=l_inv),
                 lambda a=a2: ft.grahmc_multistep_plain(*a, key=key, call=0, l_inv=l_inv)))
    if "rwmh" in state:
        scale, _, init, _ = state["rwmh"]
        qr = init.float().contiguous()
        a3 = (info, rwmh_t, qr, device_lp(info)(qr).contiguous(), fr.rwmh_scale(scale, dev),
              chains)
        runs.append(("rwmh_multistep_kernel", (0, rwmh_t),
                     lambda a=a3: fr.rwmh_multistep_kernel(*a, key=key, call=0),
                     lambda a=a3: fr.rwmh_multistep_plain(*a, key=key, call=0)))
    for name, (L, T), kern_fn, plain_fn in runs:
        pair = f"{name} ({family})"
        ms = _interleaved(torch, {"kernel": kern_fn, "plain": plain_fn}, reps,
                          {"kernel": burst, "plain": plain_burst})
        times[pair] = (statistics.median(ms["kernel"]), statistics.median(ms["plain"]))
        shapes[pair] = (chains, dim, L, T)
        per = (f" ({_per_substep(times[pair][0], chains, L, T):.4f} ns a chain-substep)"
               if name.startswith("grahmc_multistep") else "")
        say(f"  {pair} ({chains} x {dim}, L = {L}, T = {T}): kernel "
            f"{times[pair][0]:.4f} ms{per}, plain {times[pair][1]:.4f} ms")
        if name.startswith("grahmc_multistep"):
            say_lane_ptxas(log, "grahmc_multistep_kernel", info["family"], dim,
                           metric == "dense")
    if "nuts" in state:
        step, inv_mass, pos, _ = state["nuts"]
        q = pos.float().contiguous()
        lp, grad = (x.contiguous() for x in vag(q))
        invm, l_inv = ft.kernel_metric(inv_mass.to(dev))
        scalars = fn.nuts_scalars(step, 1000.0, dev)
        args = (info, NUTS_ITERS, NUTS_W, NUTS_DEPTH)
        st = tn._init_pstate(q, lp, grad, torch.float32, max_tree_depth=NUTS_DEPTH)
        for call in range(2):
            st = fn.nuts_window_kernel(*args, st, scalars, invm, key=key, call=call,
                                       l_inv=l_inv)
        states = {"kernel": st, "plain": _clone_state(st)}
        before = int(st.n_exec.sum())
        fns = {"kernel": lambda: fn.nuts_window_kernel(*args, states["kernel"], scalars, invm,
                                                       key=key, call=2, l_inv=l_inv),
               "plain": lambda: fn.nuts_window_plain(*args, states["plain"], scalars, invm,
                                                     key=key, call=2, l_inv=l_inv)}
        ms = _interleaved(torch, fns, reps, {"kernel": burst, "plain": plain_burst})
        pair = f"{NUTS_NAMES[fn.variant(st, invm)]} ({family})"
        times[pair] = (statistics.median(ms["kernel"]), statistics.median(ms["plain"]))
        measured[pair] = {"leapfrogs": (int(states["kernel"].n_exec.sum()) - before)
                          / (1 + reps * burst)}
        shapes[pair] = (chains, dim, 0, NUTS_ITERS)
        say(f"  {pair} ({chains} x {dim}, {NUTS_ITERS} iterations x W = {NUTS_W}): "
            f"kernel {times[pair][0]:.4f} ms, plain {times[pair][1]:.4f} ms; "
            f"{measured[pair]['leapfrogs']:.0f} leapfrogs executed per call "
            f"({_us_per_leapfrog(times[pair][0], measured[pair]['leapfrogs'], chains)})")


def phase_timing_rahmc(torch, ft, fr, fn, tn, rahmc, dev, log, reps=6, burst=10,
                       plain_burst=1):
    """Each (kernel, family) pair the [5o] cells launched, at its cell's
    shape (1,024 chains; Rosenbrock's 10-D cell), as _time_family times
    them. Returns ({pair: (kernel ms, plain ms)}, {pair: {"leapfrogs": per
    call}}, {pair: (chains, dim, L, T)} the shapes for the bounds)."""
    say(f"[6h] the new families' kernels at their cells' shapes: CUDA events, median of {reps} "
        f"bursts of {burst} kernel / {plain_burst} plain calls")
    key = ft.PhiloxStream.from_generator(_gen(torch, dev, 49), dev).key
    times, measured, shapes = {}, {}, {}
    done = set()
    for cell, out in rahmc.items():
        family = out["family"]
        if family in done:          # Rosenbrock: its 10-D cell
            continue
        done.add(family)
        _, dim, _, metric, schedule, n_steps = RAHMC_CELLS[cell]
        _time_family(torch, ft, fr, fn, tn, dev, key, family, out["info"], out["state"], dim,
                     metric, schedule, n_steps, RAHMC_RWMH_T, RAHMC_CHAINS, reps, burst,
                     plain_burst, times, measured, shapes, log)
    return times, measured, shapes


def phase_timing_sweep(torch, ft, fr, fn, tn, sweep, dev, log, reps=6, burst=10,
                       plain_burst=1):
    """Kernels 1, 2, 3 and 4 on each family of the sweep at its cell's shape
    (1,024 x 10: L = 16, T = 8; RWMH T = 16; NUTS 16 iterations x W = 4) from
    the sweep's tuned states, as _time_family times them; returns as
    phase_timing_rahmc."""
    say(f"[6i] the family sweep's kernels at its shape: CUDA events, median of {reps} "
        f"bursts of {burst} kernel / {plain_burst} plain calls")
    key = ft.PhiloxStream.from_generator(_gen(torch, dev, 51), dev).key
    times, measured, shapes = {}, {}, {}
    for family, state in sweep["states"].items():
        _time_family(torch, ft, fr, fn, tn, dev, key, family, state["info"], state, SWEEP_DIM,
                     "diagonal", "constant", SWEEP_L, SWEEP_RWMH_T, SWEEP_CHAINS, reps, burst,
                     plain_burst, times, measured, shapes, log)
    return times, measured, shapes


def rahmc_eval_flops(info):
    """Float operations of one evaluation (lp and gradient) of Rosenbrock's
    or a RAHMC family's device function for one chain, counted as
    csrc/targets.cuh writes it (an exp, log, division or sign one each):
    Rosenbrock 14 per coordinate (the residual, its square and the
    (1 - q)^2 term, the forward and backward gradient terms); the bimodal
    funnel ~32 in all (two shell terms, their logsumexp, the conditional,
    two gradient entries). Concentric L1: one group sum u = |q|_1 (|.| and
    an add, 2 per coordinate) shared by every shell; per shell the max pass
    (shell_term's 4 and a max) and the sum pass (shell_term again, the
    subtraction, exp and add, shell_slope's 3, a product and an add): 17;
    the division, log and add: 3; the gradient's sign and product, 2 per
    coordinate. Nested L1: per shell a group sum of |q - c_k| (3 per
    coordinate), the max pass (5), the sum pass (shell_term, subtraction,
    exp, add, shell_slope, product: 11) and the gradient's q - c_k, sign,
    product and add (4 per coordinate); then a division per coordinate, the
    log and an add."""
    dim, family = info["dim"], info["family"]
    if family == "rosenbrock":
        return 14 * dim
    if family == "multimodal_funnel_2d":
        return 32
    from mcmc_tpu_torch.ops.padded_targets import device_shells
    shells = len(device_shells(info))
    if family == "concentric_l1_balls":
        return 4 * dim + 17 * shells + 3
    return shells * (7 * dim + 16) + dim + 2


def family_eval_flops(info):
    """Float operations of one evaluation of a family's device function for
    one chain: TARGET_FLOPS per coordinate, or rahmc_eval_flops."""
    if info["family"] in TARGET_FLOPS:
        return TARGET_FLOPS[info["family"]] * info["dim"]
    return rahmc_eval_flops(info)


def pair_bounds(infos, measured, shapes):
    """Each (kernel, family) pair's bound at its [6h] or [6i] shape, as
    kernel_bounds counts them: every input read once and every output
    written once; the leapfrogs' float operations with the family's
    evaluation (family_eval_flops) in place of a target's per-coordinate
    count, the dense products of 1a/2a/4b, kernel 4's measured leapfrogs.
    `infos` maps each family to its kernel_info."""
    out = {}
    chain = 4
    for pair, (C, D, L, T) in shapes.items():
        name, family = pair.split(" (")
        info = {**infos[family[:-1]], "dim": D}
        ev = family_eval_flops(info)
        row = D * 4
        dense = "[dense]" in name
        metric_io = 2 * D * row if dense else row
        if name.startswith("grahmc"):
            if dense:
                per = (D * (L * DENSE_SUBSTEP_FLOPS + DENSE_TRANSITION_FLOPS) + L * ev
                       + (L + 2) * 2 * D * D + D * (D + 1))
            else:
                per = D * (L * SUBSTEP_FLOPS + TRANSITION_FLOPS) + L * ev
            if T == 1:
                io = C * (2 * row + chain) + C * (3 * row + 3 * chain + 1)
            else:
                io = C * (2 * row + chain) * 2 + T * C * (1 + chain + row + chain)
            out[pair] = bound(io + metric_io, T * C * per)
        elif name.startswith("rwmh"):
            io = C * (row + 4) * 2 + T * C + T * C * (row + 4)
            out[pair] = bound(io, T * C * (D * 8 + ev))
        else:
            state = C * (14 * row + 17 * chain + 2)
            per_leaf = D * (LEAPFROG_FLOPS + (4 * D if dense else 0)) + ev
            out[pair] = bound(2 * state + metric_io, measured[pair]["leapfrogs"] * per_leaf)
    return out


# ---------------------------------------------------------------------------
# Phase 6: kernel and plain times at the main-path shapes
# ---------------------------------------------------------------------------

def _event_ms(torch, fn, burst):
    """Device time per call of `burst` back-to-back calls between two CUDA
    events. The device first sleeps HOLD_CYCLES while the host enqueues the
    burst, so the host's Python time per call, which can be as long as a
    short kernel's own, does not enter a kernel's time; a plain version,
    whose host time far exceeds the hold, is timed with its host gaps as
    before."""
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


def _per_substep(ms, chains, steps, transitions=1):
    """A kernel's time per chain-substep (chains x L x T), in ns."""
    return 1e6 * ms / (chains * steps * transitions)


def say_lane_ptxas(log, kernel, family, dim, dense=False):
    """The ptxas lines of `kernel`'s instances for `family` (a kernel
    family, FAMILY_IDS) at dim's K under the metric, every lane count G
    (its last template argument; the lane groups G < 32,
    csrc/trajectory.cuh:step_lanes)."""
    from mcmc_tpu_torch.ops.padded_targets import FAMILY_IDS
    k = -(-dim // 32)
    for line in ptxas_summary(log):
        if re.match(rf"_ZN4mcmc\d+{kernel}ILi{FAMILY_IDS[family]}ELi{k}ELb{int(dense)}ELi\d+EE",
                    line):
            say(f"  ptxas: {line}")


def phase_timing(torch, ft, targets, step, dev, log, reps=20, burst=10):
    """Median over `reps` samples of the time per call of kernel and plain
    version at the main-path shape, Philox mode as on the main path, samples
    interleaved in turns (plain, kernel, kernel, plain, ...); each time also
    per chain-substep, and the ptxas lines of kernel 1's instances on the
    funnel at D = 50 (from the build `log`)."""
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
            f"{NUM_STEPS}): kernel {times[name][0]:.4f} ms "
            f"({_per_substep(times[name][0], n, NUM_STEPS, *lead):.4f} ns a chain-substep), "
            f"plain {times[name][1]:.4f} ms; kernel quartiles "
            f"{[round(x, 4) for x in statistics.quantiles(ms['kernel'], n=4)]}")
    say_lane_ptxas(log, "grahmc_step_kernel", "neals_funnel", DIM)
    say_lane_ptxas(log, "grahmc_multistep_kernel", "neals_funnel", DIM)
    return times


def phase_timing_dense(torch, ft, targets, row, dev, log, reps=10, burst=10, plain_burst=1):
    """Kernels 1a (65,536 x 50, L = 16) and 2a (4,096 x 50, T = 8, L = 16)
    against their plain versions with the learned metric at the tuned step,
    Philox mode, from the warmed positions: median over `reps` samples,
    interleaved, `burst` kernel or `plain_burst` plain calls per sample. Then
    1a and kernel 1 at the row's 4,096-chain warmups' shape (4,096 x 50; kernel
    1 with the learned metric's diagonal), and 1a's yardstick on no path:
    DENSE_PRODUCTS torch.matmul(p, M^{-1}) calls at 65,536 x 50 by 50 x 50
    (cuBLAS float32, TF32 off), 1a's products per transition. Returns
    ({name: (kernel ms, plain ms)}, the yardstick's ms)."""
    say(f"[6c] kernels 1a and 2a vs plain versions: CUDA events, median of {reps} bursts "
        f"of {burst} kernel / {plain_burst} plain calls, Philox mode")
    t = _target(targets, "correlated_gaussian")
    info = t.value_and_grad_fn.kernel_info
    invm, l_inv = ft.prepare_dense_metric(row["inv_mass"])
    diag = torch.diagonal(invm).contiguous()
    scalars = ft.kernel_scalars(row["step"], row["gamma"], row["steepness"], dev)
    key = ft.PhiloxStream.from_generator(_gen(torch, dev, 42), dev).key
    times = {}
    for name, n, kernel_fn, plain_fn, lead, metric, factor in (
            ("grahmc_step_kernel[dense]", CHAINS, ft.grahmc_step_kernel,
             ft.grahmc_step_plain, (), invm, l_inv),
            ("grahmc_multistep_kernel[dense]", MULTI_CHAINS, ft.grahmc_multistep_kernel,
             ft.grahmc_multistep_plain, (MULTI_T,), invm, l_inv),
            ("grahmc_step_kernel[dense] (4,096 chains)", MULTI_CHAINS, ft.grahmc_step_kernel,
             ft.grahmc_step_plain, (), invm, l_inv),
            ("grahmc_step_kernel (4,096 chains)", MULTI_CHAINS, ft.grahmc_step_kernel,
             ft.grahmc_step_plain, (), diag, None)):
        q = row["pos"][:n].contiguous()
        lp, grad = t.value_and_grad_fn(q)
        args = (info, NUM_STEPS, ft.SCHEDULE_IDS["constant"], *lead, q, lp.contiguous(),
                grad.contiguous(), scalars, metric)
        fns = {"kernel": lambda: kernel_fn(*args, key=key, call=0, l_inv=factor),
               "plain": lambda: plain_fn(*args, key=key, call=0, l_inv=factor)}
        ms = _interleaved(torch, fns, reps, {"kernel": burst, "plain": plain_burst})
        times[name] = (statistics.median(ms["kernel"]), statistics.median(ms["plain"]))
        say(f"  {name} ({n} x {DIM}{', T = %d' % MULTI_T if lead else ''}, L = {NUM_STEPS}): "
            f"kernel {times[name][0]:.4f} ms "
            f"({_per_substep(times[name][0], n, NUM_STEPS, *lead):.4f} ns a chain-substep), "
            f"plain {times[name][1]:.4f} ms; kernel "
            f"quartiles {[round(x, 4) for x in statistics.quantiles(ms['kernel'], n=4)]}")
    say_lane_ptxas(log, "grahmc_multistep_kernel", "correlated_gaussian", DIM, dense=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    p = torch.randn((CHAINS, DIM), generator=_gen(torch, dev, 43), device=dev)

    def products():
        for _ in range(DENSE_PRODUCTS):
            torch.matmul(p, invm)
    products()
    yard_ms = statistics.median(_event_ms(torch, products, burst) for _ in range(reps))
    say(f"  1a's yardstick, on no path: {DENSE_PRODUCTS} torch.matmul(p, M^-1) at {CHAINS} x "
        f"{DIM} by {DIM} x {DIM} (cuBLAS float32, TF32 off) {yard_ms:.4f} ms; 1a "
        f"{times['grahmc_step_kernel[dense]'][0]:.4f} ms a transition")
    return times, yard_ms


def phase_multistep_switch(torch, targets, samplers, row, dev, chain_counts=(1024, 4096)):
    """grahmc_run end to end at the multistep switch: MULTI_SAMPLES draws
    take the multi-transition dispatch (T = 8), one draw fewer the
    single-transition one (T = 1, as no T > 1 divides it), each with the
    learned dense metric and with its diagonal, from the warmed positions at
    the tuned step. Host clock around synchronized runs, the median of 3
    after a warm-up; chain-steps/s per dispatch."""
    say(f"[6d] the multistep switch: grahmc_run at {list(chain_counts)} chains, "
        f"T = {MULTI_T} against T = 1, dense and diagonal metric")
    t = _target(targets, "correlated_gaussian")
    out = {}
    for metric_name, metric in (("dense", row["inv_mass"]),
                                 ("diagonal", torch.diagonal(row["inv_mass"]).contiguous())):
        for n in chain_counts:
            for samples in (MULTI_SAMPLES, MULTI_SAMPLES - 1):
                def run(seed):
                    return samplers.grahmc_run(
                        _gen(torch, dev, seed), t.log_prob_fn, row["pos"][:n].contiguous(),
                        step_size=row["step"], num_steps=NUM_STEPS, gamma=row["gamma"],
                        steepness=row["steepness"], num_samples=samples,
                        friction_schedule=samplers.constant_schedule,
                        inv_mass_matrix=metric, value_and_grad_fn=t.value_and_grad_fn,
                        collect_chains=COLLECT, backend="fused")
                run(90)
                dts = []
                for rep in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(91 + rep)
                    torch.cuda.synchronize()
                    dts.append(time.perf_counter() - t0)
                per_call = MULTI_T if samples % MULTI_T == 0 else 1
                out[metric_name, n, per_call] = n * samples / statistics.median(dts)
            say(f"  {metric_name}, {n} chains: chain-steps/s T = {MULTI_T} "
                f"{out[metric_name, n, MULTI_T]:.1f}, T = 1 {out[metric_name, n, 1]:.1f}")
    return out


def phase_timing_rwmh_nuts(torch, ft, fr, fn, tn, targets, nuts_step, dense_step, dev,
                           reps=10, burst=10, plain_burst=1):
    """Kernel 3 and kernel 4's four variants against their plain versions at
    the rows' shapes, Philox mode: median over `reps` samples, `burst`
    kernel calls or `plain_burst` plain calls per sample. A NUTS window runs
    on from a state that two windows have already advanced, as in a run;
    for its bound, the kernel's executed leapfrogs per call are counted and
    its live checkpoint-stack slots read before and after the timed calls.
    Then 4b's yardstick, on no path: its window's dense products as
    full-batch torch.matmul(p, M^{-1}) calls (cuBLAS float32, TF32 off), a
    velocity and a kinetic energy a leapfrog and an unwhitening and a
    kinetic energy a start (starts counted as the transitions the window
    completes), as many batches as the window ran rows of them. Returns
    {name: (kernel ms, plain ms)} and {name: {"leapfrogs": per call,
    "stack_slots": live slots carried into a window and out of it}}, with
    "yardstick_ms" and "products" beside 4b's."""
    say(f"[6b] kernels 3 and 4 vs plain versions: CUDA events, median of {reps} "
        f"bursts of {burst} kernel / {plain_burst} plain calls, Philox mode")
    g = _gen(torch, dev, 41)
    key = ft.PhiloxStream.from_generator(g, dev).key
    times, measured = {}, {}

    t = targets.standard_normal(RWMH_DIM)
    q = torch.randn((RWMH_CHAINS, RWMH_DIM), generator=g, device=dev) * 0.3
    args = (t.value_and_grad_fn.kernel_info, RWMH_T, q, t.log_prob_fn(q).contiguous(),
            fr.rwmh_scale(RWMH_SCALE, dev), RWMH_COLLECT)
    fns = {"kernel": lambda: fr.rwmh_multistep_kernel(*args, key=key, call=0),
           "plain": lambda: fr.rwmh_multistep_plain(*args, key=key, call=0)}
    ms = _interleaved(torch, fns, reps, {"kernel": burst, "plain": plain_burst})
    times["rwmh_multistep_kernel"] = (statistics.median(ms["kernel"]),
                                      statistics.median(ms["plain"]))
    say(f"  rwmh_multistep_kernel ({RWMH_CHAINS} x {RWMH_DIM}, T = {RWMH_T}): kernel "
        f"{times['rwmh_multistep_kernel'][0]:.4f} ms, plain "
        f"{times['rwmh_multistep_kernel'][1]:.4f} ms")

    for family, multinomial, dense, step in (
            ("neals_funnel", False, False, nuts_step), ("neals_funnel", True, False, nuts_step),
            ("correlated_gaussian", False, True, dense_step),
            ("correlated_gaussian", True, True, dense_step)):
        t = _target(targets, family)
        info = t.value_and_grad_fn.kernel_info
        q = torch.randn((NUTS_CHAINS, DIM), generator=g, device=dev) * 0.5
        lp, grad = t.value_and_grad_fn(q)
        scalars = fn.nuts_scalars(step, 1000.0, dev)
        inv_mass, l_inv = ft.kernel_metric((t.true_cov if dense else torch.ones(DIM)).to(dev))
        args = (info, NUTS_ITERS, NUTS_W, NUTS_DEPTH)
        state = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial,
                                max_tree_depth=NUTS_DEPTH)
        for call in range(2):
            state = fn.nuts_window_kernel(*args, state, scalars, inv_mass, key=key,
                                          call=call, l_inv=l_inv)
        states = {"kernel": state, "plain": _clone_state(state)}
        before = int(state.n_exec.sum())
        done_before = int(state.transitions.sum())
        slots_before = live_stack_slots(state)
        fns = {"kernel": lambda: fn.nuts_window_kernel(*args, states["kernel"], scalars,
                                                       inv_mass, key=key, call=2,
                                                       l_inv=l_inv),
               "plain": lambda: fn.nuts_window_plain(*args, states["plain"], scalars,
                                                     inv_mass, key=key, call=2,
                                                     l_inv=l_inv)}
        ms = _interleaved(torch, fns, reps, {"kernel": burst, "plain": plain_burst})
        name = NUTS_NAMES[fn.variant(state, inv_mass)]
        calls = 1 + reps * burst
        measured[name] = {
            "leapfrogs": (int(states["kernel"].n_exec.sum()) - before) / calls,
            "stack_slots": slots_before + live_stack_slots(states["kernel"])}
        times[name] = (statistics.median(ms["kernel"]), statistics.median(ms["plain"]))
        say(f"  {name} ({family}, {NUTS_CHAINS} x {DIM}, {NUTS_ITERS} iterations x W = "
            f"{NUTS_W}, step {float(step):.4f}): kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms; {measured[name]['leapfrogs']:.0f} leapfrogs executed "
            f"per call "
            f"({_us_per_leapfrog(times[name][0], measured[name]['leapfrogs'], NUTS_CHAINS)}); "
            f"live stack slots in and out {measured[name]['stack_slots']}")
        if name == NUTS_NAMES["dense"]:
            starts = (int(states["kernel"].transitions.sum()) - done_before) / calls
            n_mm = max(1, round(2 * (measured[name]["leapfrogs"] + starts) / NUTS_CHAINS))
            torch.backends.cuda.matmul.allow_tf32 = False
            p = torch.randn((NUTS_CHAINS, DIM), generator=_gen(torch, dev, 48), device=dev)

            def products():
                for _ in range(n_mm):
                    torch.matmul(p, inv_mass)
            products()
            measured[name]["products"] = n_mm
            measured[name]["yardstick_ms"] = statistics.median(
                _event_ms(torch, products, 1) for _ in range(reps))
            say(f"  4b's yardstick, on no path: {n_mm} torch.matmul(p, M^-1) at {NUTS_CHAINS} "
                f"x {DIM} by {DIM} x {DIM} (cuBLAS float32, TF32 off; the window's "
                f"{measured[name]['leapfrogs']:.0f} leapfrogs and {starts:.0f} starts, two "
                f"products each) {measured[name]['yardstick_ms']:.4f} ms")
    return times, measured


def phase_timing_variants(torch, ft, targets, samplers, dev, log, reps=10, burst=10,
                          plain_burst=1):
    """Kernels 1b (the tempered row's 6 x 8,192 x 10 replicas and rung
    table, L = 16) and 1c (65,536 x 10, L = 16, beta 0.5; and the SMC row's
    32,768 x 10, L = 8, printed) against their plain versions, Philox mode:
    median over `reps` samples, interleaved, `burst` kernel or `plain_burst`
    plain calls per sample; each time also per chain-substep, and the ptxas
    lines of 1b's and 1c's instances on the mixture at D = 10 (from the
    build `log`; both run 4-lane groups at these shapes)."""
    say(f"[6e] kernels 1b and 1c vs plain versions: CUDA events, median of {reps} bursts of "
        f"{burst} kernel / {plain_burst} plain calls, Philox mode")
    t = targets.get_target("gaussian_mixture", dim=TEMP_DIM)
    info = t.value_and_grad_fn.kernel_info
    ones = torch.ones(TEMP_DIM, device=dev)
    key = ft.PhiloxStream.from_generator(_gen(torch, dev, 43), dev).key
    betas = samplers.geometric_ladder(TEMP_K, TEMP_BETA_MIN, device=dev)
    n = TEMP_K * TEMP_CHAINS
    args = (info, TEMP_L, ft.SCHEDULE_IDS["tanh"],
            *_mixture_state(torch, t, n, 44, dev, betas.repeat_interleave(TEMP_CHAINS)),
            ft.rung_table(TEMP_STEP / torch.sqrt(betas), TEMP_GAMMA, TEMP_STEEP, betas, dev), ones)
    cases = [("grahmc_scaled_kernel", f"{TEMP_K} x {TEMP_CHAINS} x {TEMP_DIM}, L = {TEMP_L}",
              ft.grahmc_scaled_kernel, ft.grahmc_scaled_plain, args, n * TEMP_L)]
    base = ft.bridge_base(None, SMC_BASE_SCALE, TEMP_DIM, dev)
    for label, n_p, steps in (("grahmc_bridged_kernel", MOVE_P, MOVE_L),
                              ("grahmc_bridged_kernel (SMC row)", SMC_P, SMC_L)):
        q = t.init_sampler(_gen(torch, dev, 45), n_p)
        lp, grad = ft.bridged_vag(ft.device_vag(info), torch.tensor(0.5, device=dev),
                                  torch.tensor(base.log_norm, dtype=torch.float32,
                                               device=dev), base.mean, base.inv_scale)(q)
        cases.append((label, f"{n_p} x {TEMP_DIM}, L = {steps}, beta 0.5",
                      ft.grahmc_bridged_kernel, ft.grahmc_bridged_plain,
                      (info, steps, 0, q, lp.contiguous(), grad.contiguous(),
                       ft.bridge_scalars(SMC_STEP, 0.0, 1.0, 0.5, base.log_norm, dev),
                       base.mean, base.inv_scale, ones), n_p * steps))
    times = {}
    for name, shape, kernel_fn, plain_fn, a, substeps in cases:
        fns = {"kernel": lambda: kernel_fn(*a, key=key, call=0),
               "plain": lambda: plain_fn(*a, key=key, call=0)}
        ms = _interleaved(torch, fns, reps, {"kernel": burst, "plain": plain_burst})
        times[name] = (statistics.median(ms["kernel"]), statistics.median(ms["plain"]))
        say(f"  {name} ({shape}): kernel {times[name][0]:.4f} ms "
            f"({_per_substep(times[name][0], substeps, 1):.4f} ns a chain-substep), plain "
            f"{times[name][1]:.4f} ms; kernel quartiles "
            f"{[round(x, 4) for x in statistics.quantiles(ms['kernel'], n=4)]}")
    say_lane_ptxas(log, "grahmc_scaled_kernel", "gaussian_mixture", TEMP_DIM)
    say_lane_ptxas(log, "grahmc_bridged_kernel", "gaussian_mixture", TEMP_DIM)
    return times


def phase_timing_hier(torch, ft, fr, fn, tn, targets, row, dev, reps=6, burst=10,
                      plain_burst=1):
    """Kernels 1d (8,192 x 100, L = 16), 2b (4,096 x 100, T = 8), 3a (8,192
    x 100, T = 32) and 4c (8,192 x 100, 16 iterations x W = 4) against their
    plain versions at config 5's tuned step, gamma, metric and NUTS step from
    the warmed positions, Philox mode: median over `reps` samples,
    interleaved, `burst` kernel or `plain_burst` plain calls per sample; 4c,
    and kernel 4's multinomial variant on the same data (the row's
    multinomial runs launch it), from a state two windows in. Then the target's share for reference: the eager
    value_and_grad (two cuBLAS float32 products, TF32 off) at 8,192 x 100 x
    256, on no path; and 3a's yardstick, on no path: its call's RWMH_T
    products z = q X^T as full-batch torch.matmul of (8,192 x 100) by (100 x
    256), cuBLAS float32, TF32 off. Returns ({name: (kernel ms, plain ms)},
    kernel 4's data variants' leapfrogs per call and live stack slots as
    phase_timing_rwmh_nuts counts them, with "yardstick_ms" and "products"
    under 3a's name, the eager value_and_grad's ms)."""
    say(f"[6f] kernels 1d, 2b, 3a and 4c (all four block-tiled) vs plain versions: CUDA "
        f"events, median of {reps} "
        f"bursts of {burst} kernel / {plain_burst} plain calls, Philox mode")
    t = _hier_target(targets)
    info = t.value_and_grad_fn.kernel_info
    key = ft.PhiloxStream.from_generator(_gen(torch, dev, 46), dev).key
    inv_mass = row["inv_mass"].float().contiguous()
    scalars = ft.kernel_scalars(row["step"], row["gamma"], row["steepness"], dev)
    q = row["pos"].float().contiguous()
    lp, grad = (x.contiguous() for x in t.value_and_grad_fn(q))
    n = HIER_MULTI_CHAINS
    tanh = ft.SCHEDULE_IDS["tanh"]
    step_args = (info, HIER_L, tanh, q, lp, grad, scalars, inv_mass)
    multi_args = (info, HIER_L, tanh, MULTI_T, q[:n].contiguous(), lp[:n].contiguous(),
                  grad[:n].contiguous(), scalars, inv_mass)
    rwmh_args = (info, RWMH_T, q, lp, fr.rwmh_scale(row["rwmh_scale"], dev), COLLECT)
    nscalars = fn.nuts_scalars(row["nuts_step"], 1000.0, dev)
    nuts_args = (info, NUTS_ITERS, NUTS_W, NUTS_DEPTH)
    cases = [
        ("grahmc_step_kernel[data]", f"{HIER_CHAINS} x {HIER_DIM}, L = {HIER_L}",
         lambda: ft.grahmc_step_kernel(*step_args, key=key, call=0),
         lambda: ft.grahmc_step_plain(*step_args, key=key, call=0)),
        ("grahmc_multistep_kernel[data]", f"{n} x {HIER_DIM}, T = {MULTI_T}, L = {HIER_L}",
         lambda: ft.grahmc_multistep_kernel(*multi_args, key=key, call=0),
         lambda: ft.grahmc_multistep_plain(*multi_args, key=key, call=0)),
        ("rwmh_multistep_kernel[data]", f"{HIER_CHAINS} x {HIER_DIM}, T = {RWMH_T}",
         lambda: fr.rwmh_multistep_kernel(*rwmh_args, key=key, call=0),
         lambda: fr.rwmh_multistep_plain(*rwmh_args, key=key, call=0)),
    ]
    windows = {}          # kernel 4's variants: the state a window runs on from
    for multinomial in (False, True):
        state = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial,
                                max_tree_depth=NUTS_DEPTH)
        for call in range(2):
            state = fn.nuts_window_kernel(*nuts_args, state, nscalars, inv_mass, key=key,
                                          call=call)
        name = NUTS_NAMES[fn.variant(state, inv_mass, info)]
        states = {"kernel": state, "plain": _clone_state(state)}
        windows[name] = (states, int(state.n_exec.sum()), live_stack_slots(state))
        cases.append((name, f"{HIER_CHAINS} x {HIER_DIM}, {NUTS_ITERS} iterations x W = {NUTS_W}",
                      lambda st=states: fn.nuts_window_kernel(*nuts_args, st["kernel"], nscalars,
                                                              inv_mass, key=key, call=2),
                      lambda st=states: fn.nuts_window_plain(*nuts_args, st["plain"], nscalars,
                                                             inv_mass, key=key, call=2)))
    times = {}
    for name, shape, kernel_fn, plain_fn in cases:
        ms = _interleaved(torch, {"kernel": kernel_fn, "plain": plain_fn}, reps,
                          {"kernel": burst, "plain": plain_burst})
        times[name] = (statistics.median(ms["kernel"]), statistics.median(ms["plain"]))
        say(f"  {name} ({shape}): kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} "
            f"ms; kernel quartiles "
            f"{[round(x, 4) for x in statistics.quantiles(ms['kernel'], n=4)]}")
    measured = {}
    for name, (states, before, slots_before) in windows.items():
        measured[name] = {
            "leapfrogs": (int(states["kernel"].n_exec.sum()) - before) / (1 + reps * burst),
            "stack_slots": slots_before + live_stack_slots(states["kernel"])}
        say(f"  {name}: {measured[name]['leapfrogs']:.0f} leapfrogs executed per call; live "
            f"stack slots in and out {measured[name]['stack_slots']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t.value_and_grad_fn(q)
    vag_ms = statistics.median(_event_ms(torch, lambda: t.value_and_grad_fn(q), burst)
                               for _ in range(reps))
    say(f"  eager value_and_grad ({HIER_CHAINS} x {HIER_DIM}, n_data {HIER_N_DATA}, cuBLAS "
        f"float32, TF32 off; the target's share, on no path): {vag_ms:.4f} ms")
    from mcmc_tpu_torch.ops.padded_targets import device_data
    xt = device_data(info, dev)[1]

    def z_products():
        for _ in range(RWMH_T):
            torch.matmul(q, xt)
    z_products()
    three_a = RWMH_NAMES["rwmh+data"]
    measured[three_a] = {"products": RWMH_T, "yardstick_ms": statistics.median(
        _event_ms(torch, z_products, 1) for _ in range(reps))}
    say(f"  3a's yardstick, on no path: {RWMH_T} torch.matmul(q, X^T) at {HIER_CHAINS} x "
        f"{HIER_DIM} by {HIER_DIM} x {HIER_N_DATA} (cuBLAS float32, TF32 off; a z-product a "
        f"transition) {measured[three_a]['yardstick_ms']:.4f} ms")
    return times, measured, vag_ms


def phase_timing_chees(torch, ft, fr, targets, row, dev, reps=10, burst=10, plain_burst=1):
    """Kernel 1 at the ChEES row's shape (2,048 x 20, no friction, the
    tuned step and metric, from the warmed positions) at each jitter
    level's L: held against its plain version (injected and Philox,
    _compare), then timed against it (CUDA events, median over
    `reps` samples, interleaved), the row's figure the draws' level shares
    times the levels' times. Then kernel 3 on Student-t at the RWMH row's
    shape (65,536 x 10, T = 32), its bound from kernel_bounds. Returns
    ({name: (kernel ms, plain ms)}, max |err|, the draws' mean L)."""
    say(f"[6g] kernel 1 at the ChEES row's shape and levels, kernel 3 on Student-t: CUDA "
        f"events, median of {reps} bursts of {burst} kernel / {plain_burst} plain calls")
    t = targets.get_target("neals_funnel_noncentered", dim=CHEES_DIM)
    info = t.value_and_grad_fn.kernel_info
    g = _gen(torch, dev, 47)
    key = ft.PhiloxStream.from_generator(g, dev).key
    q = row["pos"].float().contiguous()
    lp, grad = (x.contiguous() for x in t.value_and_grad_fn(q))
    inv_mass = row["inv_mass"].float().contiguous()
    scalars = ft.kernel_scalars(row["step"], 0.0, 1.0, dev)
    err, per_level = 0.0, {}
    for n_steps in row["levels"]:
        args = (info, n_steps, 0, q, lp, grad, scalars, inv_mass)
        for mode, rand, log_u in _family_randoms(torch, ft, g, key, CHEES_CHAINS, CHEES_DIM,
                                                 inv_mass, None, dev):
            kern = ft.grahmc_step_kernel(*args, **rand)
            plain = ft.grahmc_step_plain(*args, **rand)
            torch.cuda.synchronize()
            e, _ = _compare(f"kernel 1 ChEES L={n_steps} {mode}", torch,
                            _fields(kern, proposal=True), _fields(plain, proposal=True), log_u,
                            potential=ft.device_vag(info), border_max=SPLIT_MAX)
            err = max(err, e)
        ms = _interleaved(torch, {"kernel": lambda: ft.grahmc_step_kernel(*args, key=key, call=0),
                                  "plain": lambda: ft.grahmc_step_plain(*args, key=key, call=0)},
                          reps, {"kernel": burst, "plain": plain_burst})
        per_level[n_steps] = (statistics.median(ms["kernel"]), statistics.median(ms["plain"]))
        say(f"  L = {n_steps} (share {row['weights'][n_steps]:.4f}): kernel "
            f"{per_level[n_steps][0]:.4f} ms, plain {per_level[n_steps][1]:.4f} ms")
    w = row["weights"]
    ms_k = sum(w[n] * per_level[n][0] for n in per_level)
    ms_p = sum(w[n] * per_level[n][1] for n in per_level)
    mean_l = sum(w[n] * n for n in per_level)
    say(f"  grahmc_step_kernel (ChEES row): {ms_k:.4f} ms a draw, plain {ms_p:.4f} ms (level "
        f"shares as the timed run's draws, mean L {mean_l:.4f})")

    st = targets.get_target("student_t", dim=RWMH_DIM)
    q = torch.randn((RWMH_CHAINS, RWMH_DIM), generator=g, device=dev)
    args = (st.value_and_grad_fn.kernel_info, RWMH_T, q, st.log_prob_fn(q).contiguous(),
            fr.rwmh_scale(RWMH_SCALE, dev), RWMH_COLLECT)
    ms = _interleaved(torch, {"kernel": lambda: fr.rwmh_multistep_kernel(*args, key=key, call=0),
                              "plain": lambda: fr.rwmh_multistep_plain(*args, key=key, call=0)},
                      reps, {"kernel": burst, "plain": plain_burst})
    r_k, r_p = statistics.median(ms["kernel"]), statistics.median(ms["plain"])
    say(f"  rwmh_multistep_kernel on student_t ({RWMH_CHAINS} x {RWMH_DIM}, T = {RWMH_T}): "
        f"kernel {r_k:.4f} ms, plain {r_p:.4f} ms")
    return ({"grahmc_step_kernel (ChEES row)": (ms_k, ms_p),
             "rwmh_multistep_kernel (student_t)": (r_k, r_p)}, err, mean_l)


def live_stack_slots(state):
    """Checkpoint-stack slots (a q row and a p row each) that a window must
    carry across its boundary from this state: a chain n leaves into a
    subtree of 2^depth (0 < n < 2^depth) that has not turned holds popcount(n)
    live slots, the first states of its open aligned blocks, which its later
    odd leaves check; every other slot is written before it is read within
    a window. 0 under the endpoint scheme."""
    if state.q_stk is None:
        return 0
    size = 1 << state.depth
    n = size - state.steps_left
    open_ = ~state.needs_start & ~state.turn_sub & (n > 0) & (n < size)
    live = sum((n >> b) & 1 for b in range(NUTS_DEPTH))
    return int((live * open_).sum())


# Float operations per coordinate: a target's value and gradient, a diagonal
# leapfrog with its kinetic energy (two half kicks, the drift, p M^{-1} p).
TARGET_FLOPS = {"standard_normal": 3, "neals_funnel": 5, "correlated_gaussian": 6,
                "gaussian_mixture": 5, "neals_funnel_noncentered": 3, "student_t": 7,
                "ill_conditioned_gaussian": 7, "log_gamma": 10, "log_gamma_unconstrained": 6}
SCALED_FLOPS = 1         # 1b: the gradient times beta
BRIDGED_FLOPS = 7        # 1c: z = (q - m) / S, z^2 and its sum, the mixed gradient
LEAPFROG_FLOPS = 10
SUBSTEP_FLOPS = 9        # GRAHMC: two friction scalings, two half kicks, the drift
TRANSITION_FLOPS = 13    # GRAHMC: Box-Muller momentum, two kinetic energies, flip
# the dense variants: per coordinate the same less the diagonal velocity,
# unwhitening and kinetic products, which the dense products per transition
# take over: L + 2 full D x D ones (two kinetic energies, a velocity per
# substep; a multiply and an add per entry) and the unwhitening by the lower
# triangular L^{-1}, D (D + 1) operations
DENSE_SUBSTEP_FLOPS = 8
DENSE_TRANSITION_FLOPS = 9
# the hierarchical posterior (csrc/targets.cuh), per evaluation: z = X beta
# and X^T (y - sigmoid z), a multiply and an add per entry of X's p = D - 1
# coefficient columns each; per data row |z|, exp, max, log1p, the softplus
# sum, y z, the difference and its sum (8), and for the gradient 1 + e, the
# quotient and the residual (3); per coordinate the prior's square, its sum
# and beta e^-tau subtracted (4; 2 for the log-density alone)
HIER_ROW_LP_FLOPS = 8
HIER_ROW_GRAD_FLOPS = 3
HIER_COORD_FLOPS = 4
HIER_COORD_LP_FLOPS = 2


def hier_eval_flops(grad=True, dim=HIER_DIM, n_data=HIER_N_DATA):
    """Float operations of one evaluation of config 5's target (or the
    hierarchical posterior at dim and n_data) for one chain."""
    p, n = dim - 1, n_data
    if grad:
        return (4 * n * p + (HIER_ROW_LP_FLOPS + HIER_ROW_GRAD_FLOPS) * n
                + HIER_COORD_FLOPS * dim)
    return 2 * n * p + HIER_ROW_LP_FLOPS * n + HIER_COORD_LP_FLOPS * dim


def bound(nbytes, flops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the float operations over its f32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rwmh_data_bound(chains=HIER_CHAINS, dim=HIER_DIM, n_data=HIER_N_DATA, transitions=RWMH_T,
                    n_hist=COLLECT):
    """3a's bound at a shape: q and lp read and written, the accepts, the
    first n_hist chains' history, X and y read once; per transition and
    chain the proposal's float work and its log-density alone."""
    row, data = dim * 4, (n_data * (dim - 1) + n_data) * 4
    return bound(chains * (row + 4) * 2 + transitions * chains
                 + transitions * n_hist * (row + 4) + data,
                 transitions * chains * (dim * 8 + hier_eval_flops(False, dim, n_data)))


def kernel_bounds(measured):
    """Each kernel's bound at this run's shapes: every input read once and
    every output written once; the float operations of the leapfrogs (and
    momentum draws) these inputs need, counted per coordinate -- Philox's
    integer work, per-chain scalars and, for NUTS, starts and subtree ends
    are not counted, so each bound is a lower bound. `measured` holds kernel
    4's leapfrogs per call and live checkpoint-stack slots for each variant
    (data-dependent, phase_timing_rwmh_nuts, and 4c's leapfrogs from
    phase_timing_hier): of the stacks only the slots live at a window's
    boundary must cross device memory."""
    f = TARGET_FLOPS["neals_funnel"]
    row, chain = DIM * 4, 4
    step_io = CHAINS * (2 * row + chain) + CHAINS * (3 * row + 3 * chain + 1)
    step_ops = CHAINS * DIM * (NUM_STEPS * (SUBSTEP_FLOPS + f) + TRANSITION_FLOPS)
    multi_io = (MULTI_CHAINS * (2 * row + chain) * 2
                + MULTI_T * MULTI_CHAINS * (1 + chain + row + chain))
    multi_ops = (MULTI_T * MULTI_CHAINS * DIM
                 * (NUM_STEPS * (SUBSTEP_FLOPS + f) + TRANSITION_FLOPS))
    rwmh_io = (RWMH_CHAINS * (RWMH_DIM * 4 + 4) * 2 + RWMH_T * RWMH_CHAINS
               + RWMH_T * RWMH_COLLECT * (RWMH_DIM * 4 + 4))
    rwmh_ops = RWMH_T * RWMH_CHAINS * RWMH_DIM * (8 + TARGET_FLOPS["standard_normal"])
    # dense (the correlated Gaussian): M^{-1} and L^{-1} read once more
    dense_chain = (DIM * (NUM_STEPS * (DENSE_SUBSTEP_FLOPS + TARGET_FLOPS["correlated_gaussian"])
                          + DENSE_TRANSITION_FLOPS)
                   + (NUM_STEPS + 2) * 2 * DIM * DIM + DIM * (DIM + 1))
    metric_io = 2 * DIM * row
    # kernel 1 and 1a at the dense-warmup row's 4,096-chain shape (the
    # correlated Gaussian; kernel 1 with a diagonal metric)
    small_io = MULTI_CHAINS * (2 * row + chain) + MULTI_CHAINS * (3 * row + 3 * chain + 1)
    small_ops = MULTI_CHAINS * DIM * (NUM_STEPS * (SUBSTEP_FLOPS
                                                   + TARGET_FLOPS["correlated_gaussian"])
                                      + TRANSITION_FLOPS)
    out = {"grahmc_step_kernel (4,096 chains)": bound(small_io + row, small_ops),
           "grahmc_step_kernel[dense] (4,096 chains)": bound(small_io + metric_io,
                                                             MULTI_CHAINS * dense_chain)}
    out.update({"grahmc_step_kernel": bound(step_io, step_ops),
           "grahmc_multistep_kernel": bound(multi_io, multi_ops),
           "grahmc_step_kernel[dense]": bound(step_io + metric_io, CHAINS * dense_chain),
           "grahmc_multistep_kernel[dense]": bound(multi_io + metric_io,
                                                   MULTI_T * MULTI_CHAINS * dense_chain),
           "rwmh_multistep_kernel": bound(rwmh_io, rwmh_ops),
           "rwmh_multistep_kernel (student_t)": bound(
               rwmh_io, RWMH_T * RWMH_CHAINS * RWMH_DIM * (8 + TARGET_FLOPS["student_t"]))})
    # 1b and 1c at D = 10: kernel 1's reads and writes at their row counts
    # (the rung table, scalars and base rows are a few hundred bytes)
    mix = TARGET_FLOPS["gaussian_mixture"]
    row10 = TEMP_DIM * 4

    def step_rows(n):
        return n * (2 * row10 + chain) + n * (3 * row10 + 3 * chain + 1)
    n_temp = TEMP_K * TEMP_CHAINS
    out["grahmc_scaled_kernel"] = bound(
        step_rows(n_temp),
        n_temp * TEMP_DIM * (TEMP_L * (SUBSTEP_FLOPS + mix + SCALED_FLOPS) + TRANSITION_FLOPS))
    # the SMC moves run without friction: two scalings fewer per substep
    bridged = SUBSTEP_FLOPS - 2 + mix + BRIDGED_FLOPS
    out["grahmc_bridged_kernel"] = bound(
        step_rows(MOVE_P), MOVE_P * TEMP_DIM * (MOVE_L * bridged + TRANSITION_FLOPS))
    out["grahmc_bridged_kernel (SMC row)"] = bound(
        step_rows(SMC_P), SMC_P * TEMP_DIM * (SMC_L * bridged + TRANSITION_FLOPS))
    for (multinomial, dense), family in (((False, False), "neals_funnel"),
                                         ((True, False), "neals_funnel"),
                                         ((False, True), "correlated_gaussian"),
                                         ((True, True), "correlated_gaussian")):
        name = NUTS_NAMES[("multinomial+dense" if dense else "multinomial") if multinomial
                          else ("dense" if dense else "endpoint")]
        state = NUTS_CHAINS * (14 * row + 17 * chain + 2)
        if multinomial:          # reservoir, log weights, flags
            state += NUTS_CHAINS * (2 * row + 3 * chain + 2)
        # the live stack slots, read in and written out, a q and a p row each
        stacks = measured[name]["stack_slots"] * 2 * row
        nbytes = 2 * state + stacks + (2 * DIM * row if dense else row)
        per_leaf = DIM * (LEAPFROG_FLOPS + TARGET_FLOPS[family]
                          + (4 * DIM if dense else 0) + (3 if multinomial else 0))
        out[name] = bound(nbytes, measured[name]["leapfrogs"] * per_leaf)

    # kernel 1 at the ChEES row's shape: no friction (two scalings fewer per
    # substep), the draws' mean L as phase_timing_chees weighed the levels
    c_row = CHEES_DIM * 4
    out["grahmc_step_kernel (ChEES row)"] = bound(
        CHEES_CHAINS * (2 * c_row + chain) + CHEES_CHAINS * (3 * c_row + 3 * chain + 1),
        CHEES_CHAINS * CHEES_DIM * (measured["chees_mean_l"] * (
            SUBSTEP_FLOPS - 2 + TARGET_FLOPS["neals_funnel_noncentered"]) + TRANSITION_FLOPS))

    # 1d, 2b, 3a and 4c at config 5's shapes: kernels 1, 2, 3 and 4's reads
    # and writes at D = 100, X and y read once, and the likelihood's float
    # work per evaluation (hier_eval_flops) in place of a target's per
    # coordinate; 4c's leapfrogs per call as phase_timing_hier counted them
    h_row, data = HIER_DIM * 4, (HIER_N_DATA * (HIER_DIM - 1) + HIER_N_DATA) * 4
    hc, hm = HIER_CHAINS, HIER_MULTI_CHAINS
    per_transition = (HIER_L * (hier_eval_flops() + HIER_DIM * SUBSTEP_FLOPS)
                      + HIER_DIM * TRANSITION_FLOPS)
    out["grahmc_step_kernel[data]"] = bound(
        hc * (2 * h_row + chain) + hc * (3 * h_row + 3 * chain + 1) + data,
        hc * per_transition)
    out["grahmc_multistep_kernel[data]"] = bound(
        hm * (2 * h_row + chain) * 2 + MULTI_T * hm * (1 + chain + h_row + chain) + data,
        MULTI_T * hm * per_transition)
    out["rwmh_multistep_kernel[data]"] = rwmh_data_bound()
    for multinomial in (False, True):
        name = NUTS_NAMES["multinomial+data" if multinomial else "endpoint+data"]
        state = hc * (14 * h_row + 17 * chain + 2)
        if multinomial:
            state += hc * (2 * h_row + 3 * chain + 2)
        stacks = measured[name]["stack_slots"] * 2 * h_row
        per_leaf = (HIER_DIM * (LEAPFROG_FLOPS + (3 if multinomial else 0))
                    + hier_eval_flops())
        out[name] = bound(2 * state + stacks + h_row + data,
                          measured[name]["leapfrogs"] * per_leaf)
    return out


# ----------------------------------------------------------------------------
# [7] the chain mesh: __graft_entry__.dryrun_multichip's 11 surfaces on the
# port, two gloo ranks time-sharing cuda:0, and a 1-rank NCCL group
# ----------------------------------------------------------------------------

MESH_PATH = "chain mesh [7]"
MESH_RANKS = 2
MESH_TIMEOUT = 300               # seconds a rank group may take, its start included
MESH_DRAWS = 256                 # the headline GRAHMC surface: DIM, CHAINS, NUM_STEPS
MESH_COLLECT = 64                # history prefix a rank
MESH_EAGER_CHAINS = 8192
MESH_EAGER_DRAWS = 8
MESH_NUTS_CHAINS = 16384
MESH_NUTS_SPS = 16
MESH_NUTS_DRAWS = 8
MESH_TEMP_K = 3
MESH_TEMP_DRAWS = 64
MESH_SMC_DIM = 8                 # the dryrun's funnel
MESH_SMC_P = 32768
MESH_SMC_RUNGS = 8
MESH_SMC_MOVES = 2
MESH_TUNE_DIM = 8
MESH_TUNE_CHAINS = 4096
MESH_WARMUP = dict(num_warmup=80, schedule_type="tanh", num_steps=4, exploration_steps=20,
                   adaptation_windows=[40], cooldown_steps=20, max_iter_step=20,
                   gamma_samples_per_eval=5)
MESH_CHEES = dict(num_warmup=80, exploration_steps=20, adaptation_windows=[40],
                  cooldown_steps=20)
MESH_CHEES_DRAWS = 64
MESH_BOUNDS = {"step": 0.3, "mass": 2.4, "chees": 0.35, "joint_gamma": 1.0}   # the dryrun's


def _mesh_warmup_launches():
    """Kernel-1 launches of one MESH_WARMUP run: its windows in batches of
    update_freq 100, then the gamma tune's 7 evaluations."""
    w = MESH_WARMUP
    batches = sum(-(-n // 100) for n in (w["exploration_steps"], *w["adaptation_windows"],
                                         w["cooldown_steps"]))
    return 100 * batches + 7 * (max(1, w["max_iter_step"] // 25) * 25
                                + w["gamma_samples_per_eval"])


def _mesh_surfaces(torch, mesh, only_headline=False):
    """dryrun_multichip's surfaces on this rank. Each surface's mesh run is
    counted (every count set to 0 just before it, read just after) and timed;
    its check against the 1-rank run over this rank's chains (the solo mesh
    folding by this rank) or its unsharded run comes after, uncounted."""
    from mcmc_tpu_torch import diagnostics, parallel as P, targets, tuning
    from mcmc_tpu_torch.benchmark import runner as R
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.ops import fused_rwmh as fr
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.parallel import fused_sharded as fs
    from mcmc_tpu_torch.samplers import smc as ts
    r, dev = mesh.rank, mesh.device
    solo = P.solo_mesh(dev, fold_index=r)
    out = {"rank": r, "device": str(dev), "backend": mesh.backend, "surfaces": {},
           "launches": {}, "shapes": {}, "expected": {}}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def counted(name, expected, run):
        for module in (ft, fr, fn):
            module.reset_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        got = launch_counts(ft, fr, fn)
        for key, n in got.items():
            out["launches"][key] = out["launches"].get(key, 0) + n
        for key, n in shape_counts(ft, fr, fn).items():
            out["shapes"][key] = out["shapes"].get(key, 0) + n
        for key, n in expected.items():
            out["expected"][key] = out["expected"].get(key, 0) + n
        out["surfaces"][name] = {"wall": wall, "launches": {k: n for k, n in got.items() if n},
                                 "expected": expected}
        return res

    def same(a, b):
        return float((a.double() - b.double()).abs().max()) if a.shape == b.shape else math.inf

    def block(x, n):
        local = n // mesh.size
        return x[r * local:(r + 1) * local]

    # shard_map/Pallas: kernel 1 at the headline width
    funnel = targets.get_target("neals_funnel", dim=DIM)
    init = funnel.init_sampler(gen(0), CHAINS)
    kw = dict(step_size=PARITY_STEP, num_steps=NUM_STEPS, gamma=GAMMA, steepness=STEEPNESS,
              num_samples=MESH_DRAWS, collect_chains_per_device=MESH_COLLECT)
    a = counted("kernel 1 (GRAHMC, 50-D funnel)", {"grahmc_step_kernel": MESH_DRAWS},
                lambda: fs.grahmc_run_sharded(gen(2), funnel, init, mesh, **kw))
    b = fs.grahmc_run_sharded(gen(2), funnel, block(init, CHAINS), solo, **kw)
    out["surfaces"]["kernel 1 (GRAHMC, 50-D funnel)"]["check"] = max(
        same(a.samples[:, r * MESH_COLLECT:(r + 1) * MESH_COLLECT], b.samples),
        same(block(a.final_state.position, CHAINS), b.final_state.position))
    out["surfaces"]["kernel 1 (GRAHMC, 50-D funnel)"]["accept"] = float(a.accept_rate.mean())
    out["surfaces"]["kernel 1 (GRAHMC, 50-D funnel)"]["finite"] = bool(
        torch.isfinite(a.samples).all())
    if only_headline:
        return out

    # GSPMD's counterpart: an eager sampler run on each rank's chains and
    # gathered (the runner's path for samplers without a sharded run)
    x0 = funnel.init_sampler(gen(1), MESH_EAGER_CHAINS)
    info = {"gamma": GAMMA, "steepness": STEEPNESS}
    eager = ("grahmc", funnel, None, None, 0.05, 4, MESH_EAGER_DRAWS, None, "tanh", info)

    def eager_run(g, x, m):
        args = list(eager)
        args[2], args[3] = g, x
        return R._sample(*args, backend="eager", mesh=m)
    a = counted("eager sampling path (runner)", {}, lambda: eager_run(gen(3), x0, mesh))
    b = fs.gather_result(R._sample(*eager[:2], P.rank_generator(gen(3), solo),
                                   block(x0, MESH_EAGER_CHAINS), *eager[4:], backend="eager"),
                         solo, MESH_EAGER_DRAWS)
    local = MESH_EAGER_CHAINS // mesh.size
    out["surfaces"]["eager sampling path (runner)"]["check"] = same(
        a.samples[:, r * local:(r + 1) * local], b.samples)

    # collective diagnostics: a gathered history gives the unsharded numbers
    hist = torch.randn((80, 256, MESH_TUNE_DIM), generator=gen(11), device=dev)

    def diag():
        g = fs.gather_history(block(hist.transpose(0, 1), 256).transpose(0, 1).contiguous(),
                              mesh)
        return diagnostics.split_rhat(g), diagnostics.ess_bulk(g), g
    rh, ess, g = counted("collective diagnostics", {}, diag)
    out["surfaces"]["collective diagnostics"]["check"] = max(
        same(g, hist), same(rh, diagnostics.split_rhat(hist)),
        same(ess, diagnostics.ess_bulk(hist)))

    # persistent NUTS: kernel 4, 4a, 4b
    x0 = funnel.init_sampler(gen(4), MESH_NUTS_CHAINS)
    nkw = dict(step_size=NUTS_PARITY_STEP, num_samples=MESH_NUTS_DRAWS,
               steps_per_sample=MESH_NUTS_SPS, collect_chains_per_device=MESH_COLLECT)
    for name, kernel, extra in (
            ("kernel 4 (persistent NUTS)", "nuts_window_kernel", {}),
            ("kernel 4a (multinomial NUTS)", "nuts_window_kernel[multinomial]",
             {"proposal_scheme": "multinomial"}),
            ("kernel 4b (dense-metric NUTS)", "nuts_window_kernel[dense]",
             {"inv_mass_matrix": torch.eye(DIM, device=dev) * 1.5})):
        a = counted(name, {kernel: MESH_NUTS_DRAWS},
                    lambda extra=extra: fs.nuts_persistent_run_sharded(
                        gen(5), funnel, x0, mesh, **nkw, **extra))
        b = fs.nuts_persistent_run_sharded(gen(5), funnel, block(x0, MESH_NUTS_CHAINS), solo,
                                           **nkw, **extra)
        out["surfaces"][name]["check"] = max(
            same(a.samples[:, r * MESH_COLLECT:(r + 1) * MESH_COLLECT], b.samples),
            same(block(a.final_state.position, MESH_NUTS_CHAINS), b.final_state.position))
        out["surfaces"][name]["slots"] = int(a.info["n_leapfrog_slots"])

    # tempering: kernel 1b
    mix = targets.get_target("gaussian_mixture", dim=TEMP_DIM)
    x0 = mix.init_sampler(gen(6), TEMP_CHAINS)
    tkw = dict(step_size=TEMP_STEP, num_steps=TEMP_L, num_samples=MESH_TEMP_DRAWS,
               betas=torch.tensor([1.0, 0.3, 0.08], device=dev), gamma=TEMP_GAMMA,
               steepness=TEMP_STEEP)
    a = counted("kernel 1b (tempering)", {"grahmc_scaled_kernel": MESH_TEMP_DRAWS},
                lambda: fs.tempered_run_sharded(gen(7), mix, x0, mesh, **tkw))
    b = fs.tempered_run_sharded(gen(7), mix, block(x0, TEMP_CHAINS), solo, **tkw)
    rows = MESH_TEMP_K * TEMP_CHAINS
    out["surfaces"]["kernel 1b (tempering)"]["check"] = max(
        same(block(a.samples.transpose(0, 1), TEMP_CHAINS).transpose(0, 1), b.samples),
        same(block(a.info["replica_final_positions"], rows),
             b.info["replica_final_positions"]))

    # SMC: kernel 1c, a fixed ladder; the moves alone (no resampling, a
    # fixed step) bit for bit, then the dryrun's run against the unsharded one
    sfun = targets.get_target("neals_funnel", dim=MESH_SMC_DIM)
    moves = MESH_SMC_RUNGS * MESH_SMC_MOVES
    skw = dict(n_particles=MESH_SMC_P, dim=MESH_SMC_DIM, step_size=0.3, num_steps=4,
               move_steps=MESH_SMC_MOVES, base_scale=2.0,
               betas=torch.linspace(0.2, 1.0, MESH_SMC_RUNGS), max_stages=30,
               value_and_grad_fn=sfun.value_and_grad_fn, move_backend="fused")
    pkw = dict(skw, resample_threshold=0.0, adapt_step_size=False)
    a = counted("kernel 1c (SMC moves)", {"grahmc_bridged_kernel": moves},
                lambda: fs.smc_run_sharded(gen(8), sfun.log_prob_fn, mesh, **pkw))
    b = fs.smc_run_sharded(gen(8), sfun.log_prob_fn, solo,
                           **dict(pkw, n_particles=MESH_SMC_P // mesh.size))
    out["surfaces"]["kernel 1c (SMC moves)"]["check"] = same(
        block(a.particles, MESH_SMC_P), b.particles)
    s = counted("SMC (fixed ladder)", {"grahmc_bridged_kernel": moves},
                lambda: fs.smc_run_sharded(gen(9), sfun.log_prob_fn, mesh, **skw))
    out["surfaces"]["SMC (fixed ladder)"].update(
        stages=int(s.info["n_stages"]), log_z=float(s.log_Z),
        weight_sum=float(torch.exp(s.log_weights.double()).sum()),
        finite=bool(torch.isfinite(s.particles).all()))

    # the tuners: the mesh warmup with its gamma tune, ChEES and the joint
    # gamma tuner (their unsharded runs come from the parent process)
    tfun = targets.get_target("neals_funnel", dim=MESH_TUNE_DIM)
    x0 = tfun.init_sampler(gen(12), MESH_TUNE_CHAINS)
    vag = tfun.value_and_grad_fn
    w = counted("mesh warmup and gamma tune", {"grahmc_step_kernel": _mesh_warmup_launches()},
                lambda: tuning.run_adaptive_warmup(
                    "grahmc", tfun.log_prob_fn, None, x0, gen(13), mesh=mesh,
                    value_and_grad_fn=vag, backend="fused", **MESH_WARMUP))
    out["surfaces"]["mesh warmup and gamma tune"].update(
        step=w[0], inv_mass=w[1].cpu(), gamma=w[3]["gamma"])

    def chees():
        c = tuning.run_chees_warmup("hmc", tfun.log_prob_fn, None, x0, gen(14), mesh=mesh,
                                    value_and_grad_fn=vag, **MESH_CHEES)
        run = tuning.chees_run(gen(15), tfun.log_prob_fn, c[2], c[0],
                               c[3]["trajectory_length"], MESH_CHEES_DRAWS,
                               inv_mass_matrix=c[1], value_and_grad_fn=vag, backend="fused",
                               mesh=mesh)
        return c, run
    c, run = counted("ChEES warmup and jittered run", {"grahmc_step_kernel": MESH_CHEES_DRAWS},
                     chees)
    out["surfaces"]["ChEES warmup and jittered run"].update(
        step=c[0], t_len=c[3]["trajectory_length"],
        finite=bool(torch.isfinite(run.samples).all()))

    def joint():
        return tuning.run_chees_warmup("grahmc", tfun.log_prob_fn, None, x0, gen(16),
                                       mesh=mesh, value_and_grad_fn=vag, schedule_type="tanh",
                                       gamma=1.0, gamma_tuner="joint", **MESH_CHEES)
    j = counted("joint gamma (SPSA)", {}, joint)
    grid = j[3]["gamma_tuner"] == "grid"     # fell back: the ESJD grid runs kernel 1
    out["surfaces"]["joint gamma (SPSA)"].update(step=j[0], gamma=j[3]["gamma"],
                                                 tuner=j[3]["gamma_tuner"])
    if grid:
        extra = 7 * (1000 + 150)
        out["surfaces"]["joint gamma (SPSA)"]["expected"] = {"grahmc_step_kernel": extra}
        out["expected"]["grahmc_step_kernel"] += extra
    return out


def mesh_rank(mesh):
    """A rank of [7]'s gloo group (parallel.launch runs it)."""
    import torch
    return _mesh_surfaces(torch, mesh)


def mesh_rank_nccl(mesh):
    """The 1-rank NCCL group's rank: the headline GRAHMC surface."""
    import torch
    return _mesh_surfaces(torch, mesh, only_headline=True)


def _mesh_references(torch, targets, tuning, samplers, dev):
    """The unsharded runs of the tuning and SMC surfaces (same seeds)."""
    tfun = targets.get_target("neals_funnel", dim=MESH_TUNE_DIM)
    gen = lambda seed: _gen(torch, dev, seed)          # noqa: E731
    x0 = tfun.init_sampler(gen(12), MESH_TUNE_CHAINS)
    vag = tfun.value_and_grad_fn
    w = tuning.run_adaptive_warmup("grahmc", tfun.log_prob_fn, None, x0, gen(13),
                                   value_and_grad_fn=vag, backend="fused", **MESH_WARMUP)
    c = tuning.run_chees_warmup("hmc", tfun.log_prob_fn, None, x0, gen(14),
                                value_and_grad_fn=vag, **MESH_CHEES)
    j = tuning.run_chees_warmup("grahmc", tfun.log_prob_fn, None, x0, gen(16),
                                value_and_grad_fn=vag, schedule_type="tanh", gamma=1.0,
                                gamma_tuner="joint", **MESH_CHEES)
    sfun = targets.get_target("neals_funnel", dim=MESH_SMC_DIM)
    s = samplers.smc_run(gen(9), sfun.log_prob_fn, MESH_SMC_P, MESH_SMC_DIM, 0.3, 4,
                         move_steps=MESH_SMC_MOVES, base_scale=2.0,
                         betas=torch.linspace(0.2, 1.0, MESH_SMC_RUNGS), max_stages=30,
                         value_and_grad_fn=sfun.value_and_grad_fn, move_backend="fused")
    return {"step": w[0], "inv_mass": w[1].cpu(), "chees_step": c[0],
            "chees_t": c[3]["trajectory_length"], "joint_step": j[0],
            "joint_gamma": j[3]["gamma"], "smc_stages": int(s.info["n_stages"]),
            "smc_log_z": float(s.log_Z)}


def phase_chain_mesh(torch, targets, tuning, samplers, dev, smi):
    """[7]: dryrun_multichip's 11 surfaces on MESH_RANKS gloo ranks sharing
    the card, each rank's kernels held bit for bit against 1-rank runs over
    its chains, the tuners and SMC against their unsharded runs (computed
    here while the ranks run), and the headline surface on a 1-rank NCCL
    group started with them. Returns the ranks' launch counts for `drive`."""
    from mcmc_tpu_torch.parallel.launch import RankRun
    here = os.path.abspath(__file__)
    say(f"[7] chain mesh: {MESH_RANKS} gloo ranks time-sharing {dev} ({smi}); "
        f"expect no speedup")
    t0 = time.perf_counter()
    gloo_run = RankRun(f"{here}:mesh_rank", MESH_RANKS, device="cuda", backend="gloo",
                       timeout=MESH_TIMEOUT)
    nccl_run = RankRun(f"{here}:mesh_rank_nccl", 1, device="cuda", backend="nccl",
                       timeout=MESH_TIMEOUT)
    try:
        ref = _mesh_references(torch, targets, tuning, samplers, dev)
    finally:
        ranks = gloo_run.results()
        gloo_wall = time.perf_counter() - t0
        nccl = nccl_run.results()
        nccl_wall = time.perf_counter() - t0
    say(f"  both groups started together: the gloo group done at {gloo_wall:.1f} s, the "
        f"NCCL group at {nccl_wall:.1f} s (their start and the unsharded references "
        f"included; the three ranks and this process share the card)")
    for res in ranks + nccl:
        require(res["device"] == "cuda:0", f"rank {res['rank']} on {res['device']}")
        for name, s in res["surfaces"].items():
            got = {k: n for k, n in s["launches"].items()}
            say(f"  {res['backend']} rank {res['rank']} {name}: {s['wall']:.3f} s, launches "
                f"{got or 0}" + (f", max |mesh - 1-rank| {s['check']:.1e}" if "check" in s
                                 else ""))
            require(got == {k: n for k, n in s["expected"].items() if n},
                    f"[7] rank {res['rank']} {name}: launches {got}, expected {s['expected']}")
            if "check" in s:
                require(s["check"] == 0.0, f"[7] rank {res['rank']} {name}: a rank differs "
                                           f"from its 1-rank run by {s['check']}")
    head = "kernel 1 (GRAHMC, 50-D funnel)"
    require(all(res["surfaces"][head]["finite"] for res in ranks + nccl),
            "[7] non-finite GRAHMC draws")
    m = [res["surfaces"] for res in ranks]
    for key in ("step", "gamma"):
        require(m[0]["mesh warmup and gamma tune"][key] == m[1]["mesh warmup and gamma tune"][key],
                f"[7] the ranks' warmup {key} differ")
    require(torch.equal(m[0]["mesh warmup and gamma tune"]["inv_mass"],
                        m[1]["mesh warmup and gamma tune"]["inv_mass"]),
            "[7] the ranks' metrics differ")
    w, c, j = (m[0][k] for k in ("mesh warmup and gamma tune", "ChEES warmup and jittered run",
                                 "joint gamma (SPSA)"))
    s = m[0]["SMC (fixed ladder)"]
    d = {"step": abs(math.log(w["step"] / ref["step"])),
         "mass": float(torch.max(torch.abs(torch.log(w["inv_mass"] / ref["inv_mass"])))),
         "chees_t": abs(math.log(c["t_len"] / ref["chees_t"])),
         "chees_step": abs(math.log(c["step"] / ref["chees_step"])),
         "joint_gamma": abs(math.log(j["gamma"] / ref["joint_gamma"])),
         "joint_step": abs(math.log(j["step"] / ref["joint_step"])),
         "smc_log_z": abs(s["log_z"] - ref["smc_log_z"])}
    say(f"  against the unsharded runs: |log step| {d['step']:.3f} (< {MESH_BOUNDS['step']}), "
        f"max |log mass| {d['mass']:.3f} (< {MESH_BOUNDS['mass']}), ChEES |log T| "
        f"{d['chees_t']:.3f} and |log step| {d['chees_step']:.3f} (< {MESH_BOUNDS['chees']}), "
        f"joint |log gamma| {d['joint_gamma']:.3f} (< {MESH_BOUNDS['joint_gamma']}) and |log "
        f"step| {d['joint_step']:.3f} ({j['tuner']}); SMC {s['stages']} stages (unsharded "
        f"{ref['smc_stages']}), |d log Z| {d['smc_log_z']:.4f} (< 0.5)")
    require(d["step"] < MESH_BOUNDS["step"] and d["mass"] < MESH_BOUNDS["mass"]
            and d["chees_t"] < MESH_BOUNDS["chees"] and d["chees_step"] < MESH_BOUNDS["chees"]
            and d["joint_gamma"] < MESH_BOUNDS["joint_gamma"]
            and d["joint_step"] < MESH_BOUNDS["chees"], f"[7] mesh tuners off: {d}")
    require(s["stages"] == ref["smc_stages"] == MESH_SMC_RUNGS and d["smc_log_z"] < 0.5
            and abs(s["weight_sum"] - 1.0) < 1e-4 and s["finite"], f"[7] mesh SMC: {s}, {ref}")
    require(c["finite"], "[7] non-finite ChEES draws")
    launches, shapes, expected = {}, {}, {}
    for res in ranks + nccl:
        for table, part in ((launches, res["launches"]), (shapes, res["shapes"]),
                            (expected, res["expected"])):
            for key, n in part.items():
                table[key] = table.get(key, 0) + n
    say(f"  [7] wall {time.perf_counter() - t0:.1f} s; launches a rank: "
        + "; ".join(f"{res['backend']} rank {res['rank']} "
                    f"{ {k: n for k, n in res['launches'].items() if n} }"
                    for res in ranks + nccl))
    return {"rank_launches": launches, "rank_shapes": shapes, "expected": expected,
            "wall": time.perf_counter() - t0}


def launch_counts(ft, fr, fn):
    """Each kernel's and kernel variant's launch count (the modules
    ops.fused_trajectory, ops.fused_rwmh and ops.fused_nuts)."""
    got = {f"{k.__name__}{GRAHMC_NAMES[v]}": n for k in ft.KERNELS
           for v, n in k.variant_launches.items()}
    got.update({RWMH_NAMES[v]: n for v, n in fr.rwmh_multistep_kernel.variant_launches.items()})
    got.update({NUTS_NAMES[v]: n for v, n in fn.nuts_window_kernel.variant_launches.items()})
    return got


def shape_counts(ft, fr, fn):
    """Each (kernel variant's name, family, n_chains, dim) launched, and its
    launch count."""
    got = {(f"{k.__name__}{GRAHMC_NAMES[v]}", *shape): n for k in ft.KERNELS
           for (v, *shape), n in k.shape_launches.items()}
    got.update({(RWMH_NAMES[v], *shape): n
                for (v, *shape), n in fr.rwmh_multistep_kernel.shape_launches.items()})
    got.update({(NUTS_NAMES[v], *shape): n
                for (v, *shape), n in fn.nuts_window_kernel.shape_launches.items()})
    return got


def row_launches(path_shapes):
    """Each row of the kernels line and its launches, read from every main
    path's counts by shape ({path: {(kernel, family, n_chains, dim):
    launches}}): a split row (SPLITS) takes its path's launches of its
    kernel at its chains, a path of PAIR_PATHS gives "kernel (family)"
    pairs, and every other launch goes to its kernel's own row. Returns
    ({row of KERNELS: launches}, {pair: launches}, {row or pair:
    {(n_chains, dim, family): launches}})."""
    own, pairs, shapes = {}, {}, {}
    for path, counts in path_shapes.items():
        for (name, family, n, d), c in counts.items():
            if path in PAIR_PATHS:
                row, table = f"{name} ({family})", pairs
            else:
                row = next((split for split, (base, at, chains) in SPLITS.items()
                            if (base, at) == (name, path) and chains in (None, n)), name)
                table = own
            table[row] = table.get(row, 0) + c
            at_shape = shapes.setdefault(row, {})
            at_shape[(n, d, family)] = at_shape.get((n, d, family), 0) + c
    return own, pairs, shapes


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
    for line in ptxas_summary(lib.build_log):
        say(f"  ptxas: {line}")
    if "--smc-repeat" in sys.argv[1:]:
        phase_smc_repeat(torch, targets, samplers, dev)
        return 0
    if "--chain-mesh" in sys.argv[1:]:
        for module in (ft, fr, fn):
            module.reset_launches()
        out = phase_chain_mesh(torch, targets, tuning, samplers, dev, smi[0])
        require({k: n for k, n in out["rank_launches"].items() if n}
                == {k: n for k, n in out["expected"].items() if n},
                f"{MESH_PATH}: launches {out['rank_launches']}, expected {out['expected']}")
        say(f"  launches by shape: {out['rank_shapes']}")
        return 0
    if "--runner-cell" in sys.argv[1:]:
        for module in (ft, fr, fn):
            module.reset_launches()
        out = phase_runner_cell(torch, lambda: launch_counts(ft, fr, fn))
        got = launch_counts(ft, fr, fn)
        want = {name: out["expected"].get(name, 0) for name in got}
        say(f"  launches on the {RUNNER_PATH}: {got} (expected {want})")
        require(got == want, f"{RUNNER_PATH}: launches {got}, expected {want}")
        say(f"  launches by shape: {shape_counts(ft, fr, fn)}")
        return 0

    t_checks = time.perf_counter()
    max_err = phase_parity(torch, ft, targets, dev)
    max_err.update(phase_parity_rwmh(torch, ft, fr, targets, dev))
    max_err.update(phase_parity_nuts(torch, ft, fn, tn, targets, dev))
    max_err.update(phase_parity_variants(torch, ft, targets, samplers, dev))
    family_err = phase_parity_families(torch, ft, fr, fn, tn, targets, dev)
    phase_philox_stats(torch, targets, samplers, dev)
    phase_stats_rwmh_nuts(torch, targets, samplers, dev)
    phase_multinomial_variance(torch, targets, samplers, dev)
    say(f"  the checks [3]-[4c]: {time.perf_counter() - t_checks:.1f} s")

    launches, path_counts, path_shapes, walls = {}, {}, {}, {}

    def drive(label, run, expected):
        """Run one main path with every count set to 0 just before it; each
        kernel must launch exactly as often as `expected` says (0 for the
        kernels of the other paths). A kernel's reported launches are its
        sum over the paths that run it. `expected` may be a function of the
        path's result, for a path whose launches depend on its data."""
        ft.reset_launches()
        fr.reset_launches()
        fn.reset_launches()
        t_path = time.perf_counter()
        out = run()
        walls[label] = time.perf_counter() - t_path
        got = launch_counts(ft, fr, fn)
        shapes = shape_counts(ft, fr, fn)
        if isinstance(out, dict) and "rank_launches" in out:
            # a path its rank processes ran ([7]): their counts, summed
            got = {name: out["rank_launches"].get(name, 0) for name in got}
            shapes = out["rank_shapes"]
        if callable(expected):
            expected = expected(out)
        want = {name: expected.get(name, 0) for name in got}
        say(f"  launches on the {label}: {got} (expected {want})")
        require(got == want, f"{label}: launches {got}, expected {want}")
        by_name = {name: sum(n for key, n in shapes.items() if key[0] == name) for name in got}
        require(by_name == got, f"{label}: launches by shape {shapes}, in all {got}")
        path_counts[label] = got
        path_shapes[label] = shapes
        for name in expected:
            launches[name] = launches.get(name, 0) + got[name]
        return out

    g_step = drive("GRAHMC main path",
                   lambda: phase_main_path(torch, ft, targets, samplers, tuning,
                                           diagnostics, dev),
                   {"grahmc_step_kernel": TUNE_BATCHES * TUNE_BATCH_LEN
                    + TIMED_SAMPLES * (1 + TIMED_REPS) + 2 * ESS_SAMPLES,
                    "grahmc_multistep_kernel": MULTI_SAMPLES // MULTI_T})
    row_runs = NUTS_SAMPLES * (1 + NUTS_REPS)      # windows of one timed row
    nuts = drive("NUTS and NUTS-multinomial rows",
                 lambda: phase_nuts_row(torch, targets, samplers, tuning, diagnostics,
                                        dev),
                 {"nuts_window_kernel": NUTS_TUNE_CALLS + row_runs,
                  "nuts_window_kernel[multinomial]": row_runs})
    check_runs = 2 * NUTS_SAMPLES                   # warm-up and one rep
    dense = drive("dense-metric NUTS row",
                  lambda: phase_dense_row(torch, targets, samplers, tuning, diagnostics,
                                          dev),
                  {"nuts_window_kernel[dense]": NUTS_TUNE_CALLS + row_runs + check_runs,
                   "nuts_window_kernel[multinomial+dense]": row_runs,
                   "nuts_window_kernel": NUTS_TUNE_CALLS + check_runs})
    drive("RWMH row", lambda: phase_rwmh_row(torch, targets, samplers, dev),
          {"rwmh_multistep_kernel": RWMH_SAMPLES // RWMH_T * (2 + RWMH_REPS)})
    warmed = WARMUP_TRANSITIONS + TUNE_TRANSITIONS     # one warmup with its tune
    dense_row = drive("dense-warmup GRAHMC row",
                      lambda: phase_dense_warmup_row(torch, targets, samplers, tuning,
                                                     diagnostics, dev),
                      {"grahmc_step_kernel[dense]": 2 * warmed + TUNE_TRANSITIONS
                       + TIMED_SAMPLES * (1 + TIMED_REPS) + ESS_SAMPLES,
                       "grahmc_multistep_kernel[dense]": MULTI_SAMPLES // MULTI_T,
                       "grahmc_step_kernel": warmed,
                       "grahmc_multistep_kernel": MULTI_SAMPLES // MULTI_T})
    max_err.update(phase_parity_dense(torch, ft, targets, dense_row, dev))
    tempered = drive("tempered row", lambda: phase_tempered_row(torch, targets, samplers, dev),
                     {"grahmc_scaled_kernel": TEMP_DRAWS * (2 + TEMP_REPS + 1)})
    cross = drive("crossing check", lambda: phase_crossing(torch, targets, samplers, dev),
                  {"grahmc_scaled_kernel": CROSS_BURN + CROSS_DRAWS,
                   "grahmc_multistep_kernel": (CROSS_BURN + CROSS_DRAWS) // MULTI_T})
    drive("ladder tune", lambda: phase_ladder_tune(torch, targets, samplers, tuning, dev),
          {"grahmc_scaled_kernel": LADDER_ROUNDS * LADDER_DRAWS})
    smc = drive("SMC row", lambda: phase_smc_row(torch, targets, samplers, dev),
                lambda out: {"grahmc_bridged_kernel": out["launches"]})
    move_pair = drive("SMC move-dominated pair",
                      lambda: phase_smc_move_pair(torch, targets, samplers, dev),
                      {"grahmc_bridged_kernel": (1 + MOVE_REPS) * MOVE_RUNGS * (2 + 8)})
    hier = drive("config-5 row",
                 lambda: phase_hier_row(torch, targets, samplers, tuning, diagnostics, dev),
                 {"grahmc_step_kernel[data]": (WARMUP_TRANSITIONS + TUNE_TRANSITIONS
                                               + HIER_DRAWS),
                  "grahmc_multistep_kernel[data]": HIER_MULTI_DRAWS // MULTI_T,
                  "nuts_window_kernel[data]": NUTS_TUNE_CALLS + NUTS_SAMPLES * (1 + HIER_NUTS_REPS),
                  "nuts_window_kernel[multinomial+data]": NUTS_SAMPLES,
                  "rwmh_multistep_kernel[data]": HIER_RWMH_DRAWS // RWMH_T + HIER_RWMH_KEEP})
    max_err.update(phase_parity_hier(torch, ft, fr, fn, tn, targets, hier, dev))
    chees = drive("ChEES row", lambda: phase_chees_row(torch, ft, targets, tuning, dev),
                  {"grahmc_step_kernel": CHEES_DRAWS * (2 + CHEES_REPS)})
    n_fam = len(NEW_FAMILIES)
    sweep = drive("family sweep",
                  lambda: phase_family_sweep(torch, targets, samplers, tuning, diagnostics, dev),
                  {"grahmc_step_kernel": n_fam * (WARMUP_TRANSITIONS + TUNE_TRANSITIONS),
                   "grahmc_multistep_kernel": n_fam * SWEEP_DRAWS // SWEEP_MULTI_T,
                   "rwmh_multistep_kernel": n_fam * (SWEEP_RWMH_TUNE
                                                     + SWEEP_DRAWS // SWEEP_RWMH_T),
                   "nuts_window_kernel": n_fam * (NUTS_TUNE_CALLS + SWEEP_DRAWS)})
    runner_cell = drive(RUNNER_PATH,
                        lambda: phase_runner_cell(torch, lambda: launch_counts(ft, fr, fn)),
                        lambda out: out["expected"])
    rahmc = {cell: drive(f"{cell} cell",
                         lambda cell=cell: phase_rahmc_cells(torch, targets, samplers, tuning,
                                                             diagnostics, dev, cell),
                         lambda out: out["expected"]) for cell in RAHMC_CELLS}
    classic = drive("classic NUTS path", lambda: phase_classic_nuts(
        torch, targets, samplers, tuning, diagnostics, dev), {})
    reference = drive("Rosenbrock reference run",
                      lambda: phase_rosenbrock_reference(torch, targets, dev), {})
    chain_mesh = drive(MESH_PATH, lambda: phase_chain_mesh(torch, targets, tuning, samplers, dev,
                                                           smi[0]),
                       lambda out: out["expected"])
    require(all(n > 0 for n in launches.values()) and set(launches) == set(KERNELS) - set(SPLITS),
            f"a kernel no main path launched: {launches}")
    own, pairs, own_shapes = row_launches(path_shapes)
    require(sum(own.values()) + sum(pairs.values()) == sum(launches.values())
            and all(n > 0 for n in own.values()) and set(own) == set(KERNELS),
            f"launches by row {own}, {pairs}; by kernel {launches}")

    say("  each path's wall (s): " + ", ".join(f"{label} {w:.1f}" for label, w in walls.items())
        + f"; the build, checks and paths {time.perf_counter() - t_start:.1f} s in all")
    times = phase_timing(torch, ft, targets, g_step, dev, lib.build_log)
    nuts_times, measured = phase_timing_rwmh_nuts(torch, ft, fr, fn, tn, targets,
                                                  nuts["step"], dense["step"], dev)
    times.update(nuts_times)
    dense_times, yard_ms = phase_timing_dense(torch, ft, targets, dense_row, dev, lib.build_log)
    times.update(dense_times)
    times.update(phase_timing_variants(torch, ft, targets, samplers, dev, lib.build_log))
    hier_times, hier_measured, vag_ms = phase_timing_hier(torch, ft, fr, fn, tn, targets, hier,
                                                          dev)
    times.update(hier_times)
    measured.update(hier_measured)
    say(f"  1d per gradient evaluation: {hier_times['grahmc_step_kernel[data]'][0] / HIER_L:.4f} "
        f"ms ({HIER_L} a transition); the eager value_and_grad {vag_ms:.4f} ms")
    chees_times, max_err["grahmc_step_kernel (ChEES row)"], measured["chees_mean_l"] = (
        phase_timing_chees(torch, ft, fr, targets, chees, dev))
    times.update(chees_times)
    for name, err in family_err.items():     # [3g]'s checks of the same kernels
        max_err[name] = max(max_err.get(name, 0.0), err)
    pair_times, pair_measured, pair_shapes = phase_timing_rahmc(torch, ft, fr, fn, tn, rahmc,
                                                                dev, lib.build_log)
    sweep_times, sweep_measured, sweep_shapes = phase_timing_sweep(torch, ft, fr, fn, tn, sweep,
                                                                   dev, lib.build_log)
    pair_times.update(sweep_times)
    require(set(pair_times) == set(pairs), f"timed pairs {sorted(pair_times)}, launched "
                                           f"{sorted(pairs)}")
    times.update(pair_times)
    pair_bound = pair_bounds({out["family"]: out["info"] for out in rahmc.values()},
                             pair_measured, pair_shapes)
    pair_bound.update(pair_bounds({f: st["info"] for f, st in sweep["states"].items()},
                                  sweep_measured, sweep_shapes))
    if "--multistep-switch" in sys.argv[1:]:
        phase_multistep_switch(torch, targets, samplers, dense_row, dev)
    bounds = kernel_bounds(measured)
    bounds.update(pair_bound)
    rows = {**own, **pairs}
    loss = {name: rows[name] * (times[name][0] - bounds[name][0]) / 1e3 for name in rows}
    say("[8] launches x (ms - bound) by (kernel, shape), largest first (s); the launches' "
        "chains x dim (family): count:")
    for name in sorted(loss, key=loss.get, reverse=True):
        say(f"  {name}: {rows[name]} launches x ({times[name][0]:.4f} - {bounds[name][0]:.5f} "
            f"ms) = {loss[name]:.2f} s; " + ", ".join(
                f"{n:,} x {d} ({family}): {c}"
                for (n, d, family), c in sorted(own_shapes[name].items())))
    one_a, one_d = times["grahmc_step_kernel[dense]"][0], times["grahmc_step_kernel[data]"][0]
    say(f"  1a's yardstick {yard_ms:.4f} ms against 1a's {one_a:.4f} ms; 1d per evaluation "
        f"{one_d / HIER_L:.4f} ms against the eager value_and_grad's {vag_ms:.4f} ms")
    two_b = times["grahmc_multistep_kernel[data]"][0]
    say(f"  2b, block-tiled (tiled_step.cuh:grahmc_tiled_multistep_kernel, {HIER_MULTI_CHAINS} "
        f"chains): {two_b / (MULTI_T * HIER_L):.4f} ms per evaluation of its chains against "
        f"1d's {one_d / HIER_L:.4f} ms for {HIER_CHAINS}")
    four_b, four_c = NUTS_NAMES["dense"], NUTS_NAMES["endpoint+data"]
    evals = measured[four_c]["leapfrogs"] / HIER_CHAINS
    say(f"  4b's yardstick {measured[four_b]['yardstick_ms']:.4f} ms ({measured[four_b]['products']} "
        f"matmuls) against 4b's {times[four_b][0]:.4f} ms; 4c per evaluation "
        f"{times[four_c][0] / evals:.4f} ms ({evals:.2f} a chain a window) against the eager "
        f"value_and_grad's {vag_ms:.4f} ms")
    three_a = RWMH_NAMES["rwmh+data"]
    say(f"  3a's yardstick {measured[three_a]['yardstick_ms']:.4f} ms ({RWMH_T} matmuls) "
        f"against 3a's {times[three_a][0]:.4f} ms")
    say(f"[9] done in {time.perf_counter() - t_start:.1f} s")
    say(f"  rows: nuts_useful_grads_per_sec {nuts['endpoint']['rate']:.1f}, "
        f"nuts_ess_per_sec {nuts['endpoint']['ess_rate']:.1f}, "
        f"nuts_multinomial_useful_grads_per_sec {nuts['multinomial']['rate']:.1f}, "
        f"nuts_multinomial_ess_per_sec {nuts['multinomial']['ess_rate']:.1f}, "
        f"nuts_multinomial_vs_endpoint_ess {nuts['vs_endpoint']:.4f}, "
        f"nuts_dense_useful_grads_per_sec {dense['dense']['rate']:.1f}, "
        f"nuts_dense_ess_per_sec {dense['dense']['ess_rate']:.1f}, "
        f"grahmc_dense_chain_steps_per_sec {dense_row['rate']:.1f}, "
        f"grahmc_dense_ess_per_sec {dense_row['ess_rate']:.1f}, "
        f"grahmc_dense_warmup_sec {dense_row['warmup_sec']:.4f}, "
        f"tempered_replica_transitions_per_sec {tempered['rate']:.1f}, "
        f"tempered_swap_accept {tempered['swaps']}, "
        f"tempered_cold_accept {tempered['cold']:.4f}, "
        f"tempered_crossing_right_fraction {cross['right']:.4f}, "
        f"smc_particle_leapfrogs_per_sec {smc['rate']:.1f}, smc_log_z {smc['log_z']:+.5f}, "
        f"smc_stages {smc['stages']}, smc_mode_fraction {smc['mode']:.4f}, "
        f"smc_move_dominated_leapfrogs_per_sec {move_pair['rate']:.1f}, smc_move_pair_ms "
        f"{{'moves2': {move_pair['walls'][2] * 1e3:.3f}, "
        f"'moves8': {move_pair['walls'][8] * 1e3:.3f}}}, "
        f"hier_warmup_sec {hier['warmup_sec']:.4f}, "
        f"hier_grahmc_chain_steps_per_sec {hier['rate']:.1f}, "
        f"hier_grahmc_ess_per_sec {hier['ess_rate']:.1f}, "
        f"hier_grahmc_rhat_max {hier['rhat']:.5f}, hier_grahmc_accept {hier['accept']:.4f}, "
        f"hier_nuts_useful_grads_per_sec {hier['nuts']['rate']:.1f}, "
        f"hier_nuts_ess_per_sec {hier['nuts']['ess_rate']:.1f}, "
        f"hier_rwmh_chain_steps_per_sec {hier['rwmh_rate']:.1f}, "
        f"hier_eager_value_and_grad_ms {vag_ms:.4f}, "
        f"chees_warmup_seconds {chees['warmup_sec']:.4f}, chees_T {chees['t_len']:.4f}, "
        f"chees_L {chees['num_steps']}, chees_transitions_per_sec {chees['rate']:.1f}, "
        f"chees_accept {chees['accept']:.4f}, chees_jitter_levels {chees['levels']}, "
        f"chees_busy_share {chees['busy'] / chees['wall']:.4f}, "
        f"chain_mesh_sec {chain_mesh['wall']:.1f}, "
        f"runner_cell_sec {runner_cell['wall']:.1f} ("
        + ", ".join(f"{s} {_runner_verdict(r)}" for s, r in runner_cell["rows"].items()) + ")")
    say("  family sweep (R-hat, means' max z by the chains' spread and by bulk ESS, divergence "
        "rate): " + "; ".join(
        f"{family} " + ", ".join(f"{s} {r['rhat']:.4f}/{r['z_chains']:.2f}/{r['z_ess']:.2f}/"
                                 f"{r['div']:.4f}"
                                 for s, r in rows.items())
        for family, rows in sweep["rows"].items()))
    say("  new families' cells (R-hat, means' max z by the chains' spread and by bulk ESS, "
        "gates): " + "; ".join(
            f"{cell} " + ", ".join(
                f"{sampler} {r['rhat']:.4f}/{r.get('z_chains', float('nan')):.2f}/"
                f"{r.get('z_ess', float('nan')):.2f}/{'+'.join(r['gates']) or 'none'}"
                for sampler, r in out["rows"].items())
            for cell, out in rahmc.items()))
    say("  classic NUTS (seconds per transition, mean depth, R-hat, tail share x exact, "
        "longest tail stretch): " + "; ".join(
            f"{family} {r['sec_per_transition']:.5f}/{r['depth']:.3f}/{r['rhat']:.4f}/"
            f"{r['tail']:.3f}/{r['stretch']}" for family, r in classic.items())
        + f"; generate_rosenbrock_reference {reference['seconds']:.2f} s, R-hat "
          f"{reference['rhat']:.4f}")
    st_name = "rwmh_multistep_kernel (student_t)"
    say(f"  kernel 3 on student_t at the RWMH row's shape: {times[st_name][0]:.4f} ms, plain "
        f"{times[st_name][1]:.4f} ms, bound {bounds[st_name][0]:.5f} ms, {bounds[st_name][1]}")
    say(f"  bound of 1c at the SMC row's shape: "
        f"{bounds['grahmc_bridged_kernel (SMC row)'][0]:.5f} ms, "
        f"{bounds['grahmc_bridged_kernel (SMC row)'][1]}")
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": own[name],
         "max_abs_err": max_err[name], "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name in KERNELS] + [
        {"name": pair, "route": "cuda", "source": KERNELS[pair.split(" (")[0]][0],
         "replaces": KERNELS[pair.split(" (")[0]][1], "launches": pairs[pair],
         "max_abs_err": max_err[pair], "ms": times[pair][0], "plain_ms": times[pair][1],
         "bound_ms": bounds[pair][0], "bound_by": bounds[pair][1], "library_ms": None}
        for pair in sorted(pairs)]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
