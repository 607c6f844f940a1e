"""The port's chain mesh (mcmc_tpu_torch.parallel) on two gloo ranks on the
CPU, held against the JAX package's shard_map runs on conftest's CPU mesh.

One module fixture starts the two ranks once (parallel.launch.run_ranks,
each a process with a 120 s limit); they run every case of `_cases` below
and hand the results back, and the tests assert on them:

- the collective math against the JAX package under shard_map, in float64
  to TOL = 1e-12: SMC's _lse and _rel_ess, psum_increment, the pooled
  accept statistics, sequential's _gmean, ChEES's criterion;
- the four sharded runs against the JAX sharded runs statistically (means
  within 4 MCSE, R-hat <= 1.05);
- within the port: each rank bit for bit against a 1-rank run over its
  chains (parallel.solo_mesh folding by that rank), the tempered
  continuation's round trip, fixed-ladder SMC's stages, the mesh warmup,
  gamma tune and ChEES against their unsharded runs within the dryrun's
  bounds, the same tuned values on both ranks, and the int64 slot total
  where the JAX package's uint32 one wraps.

This file is also each rank's program: the ranks import it and call
`_cases`; the JAX side is imported only by the fixtures that compute it.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcmc_tpu_torch import diagnostics as tdiag  # noqa: E402
from mcmc_tpu_torch.interop import (nuts_state_for_rank,  # noqa: E402
                                    replica_position_from_numpy)

TOL = 1e-12          # float64 collectives: the same sums in another order
WORLD = 2
DIM = 4
STAT_CHAINS = 64     # the statistical runs' global chains, 32 a rank
FUNNEL_DIM = 8
PARITY_CHAINS = 16   # the parity runs' global chains, 8 a rank
TUNE_CHAINS = 64
SLOT_TOTAL = 3_000_000_000   # a rank's leapfrog-slot total past 2^31

GR_KW = dict(step_size=0.3, num_steps=8, gamma=0.5, steepness=0.5, num_samples=400,
             collect_chains_per_device=STAT_CHAINS // WORLD)
NUTS_KW = dict(step_size=0.6, num_samples=150, steps_per_sample=16,
               collect_chains_per_device=STAT_CHAINS // WORLD)
TEMP_KW = dict(step_size=0.3, num_steps=8, num_samples=400, n_temps=3)
SMC_KW = dict(n_particles=1024, dim=DIM, step_size=0.5, num_steps=8, base_scale=2.0)
WARM_KW = dict(num_warmup=80, schedule_type="tanh", num_steps=4, exploration_steps=20,
               adaptation_windows=[40], cooldown_steps=20, max_iter_step=20,
               gamma_samples_per_eval=5)
CHEES_KW = dict(num_warmup=80, exploration_steps=20, adaptation_windows=[40],
                cooldown_steps=20)


def _collective_data():
    """The shared float64 inputs of the collective cases (numpy, global)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=64) * 3.0
    lw = x - np.log(np.sum(np.exp(x - x.max()))) - x.max()
    q0 = rng.normal(size=(32, DIM))
    q1 = q0 + rng.normal(size=(32, DIM)) * 0.5
    q1[21, 2] = np.inf                          # a diverged chain on rank 1
    a = rng.normal(size=(DIM, DIM))
    return {
        "x": x, "lw": lw,
        "pos": rng.normal(size=(32, DIM)),
        "center": rng.normal(size=DIM) * 0.1,
        "d_alpha": rng.uniform(size=32) * 3.0,
        "d_trans": rng.integers(0, 4, size=32).astype(np.float64),
        "accept": (rng.uniform(size=(25, 32)) < 0.6).astype(np.float64),
        "q0": q0, "q1": q1, "p1": rng.normal(size=(32, DIM)),
        "alpha": rng.uniform(size=32),
        "inv_mass": rng.uniform(0.5, 2.0, size=DIM),
        "dense": a @ a.T / DIM + np.eye(DIM),
        "h": 0.37, "t_len": 1.3,
    }


def _funnel_init(torch_mod, n, seed=0):
    from mcmc_tpu_torch.targets import get_target
    t = get_target("neals_funnel", dim=FUNNEL_DIM)
    return t, t.init_sampler(torch_mod.Generator().manual_seed(seed), n,
                             dtype=torch_mod.float32)


def _normal_init(n):
    rng = np.random.default_rng(1)
    return rng.normal(size=(n, DIM)).astype(np.float32)


# ----------------------------------------------------------------------------
# The ranks' program
# ----------------------------------------------------------------------------

def _cases(mesh):
    """Every case on this rank of the 2-rank gloo mesh; returns a dict."""
    from mcmc_tpu_torch.parallel import (all_gather, psum, shard_chains, solo_mesh)
    from mcmc_tpu_torch.parallel import fused_sharded as fs
    from mcmc_tpu_torch.benchmark.runner import is_writer
    from mcmc_tpu_torch.samplers.grahmc import tanh_schedule
    from mcmc_tpu_torch.samplers.smc import _lse, _rel_ess, smc_run
    from mcmc_tpu_torch.targets import get_target
    from mcmc_tpu_torch.tuning import chees_run, run_adaptive_warmup, run_chees_warmup
    from mcmc_tpu_torch.tuning.adaptation import _persistent_accept_stat
    from mcmc_tpu_torch.tuning.chees import chees_log_t_grad
    from mcmc_tpu_torch.tuning.sequential import _gmean
    from mcmc_tpu_torch.tuning.welford import (dense_moment_init, dense_moment_update,
                                               psum_increment)

    r = mesh.rank
    out = {"rank": r, "writer": is_writer()}
    G = lambda seed: torch.Generator().manual_seed(seed)       # noqa: E731
    d = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
         for k, v in _collective_data().items()}
    loc = lambda x: shard_chains(x, mesh)                      # noqa: E731

    # --- collective math (float64) ------------------------------------------
    out["lse"] = float(_lse(loc(d["x"]), mesh))
    out["rel_ess"] = float(_rel_ess(loc(d["lw"]), d["lw"].shape[0], mesh))
    old = dense_moment_init(d["center"])
    old = dense_moment_update(old, d["pos"][:4])               # a replicated carry
    new = psum_increment(dense_moment_update(old, loc(d["pos"])), old, mesh)
    out["dense_moments"] = [t.clone() for t in new]
    out["persistent_stat"] = float(_persistent_accept_stat(loc(d["d_alpha"]),
                                                           loc(d["d_trans"]), mesh=mesh))
    out["gmean"] = float(_gmean(loc(d["accept"].T).T, mesh))
    for name, inv_mass in (("chees_diag", d["inv_mass"]), ("chees_dense", d["dense"])):
        out[name] = float(chees_log_t_grad(loc(d["q0"]), loc(d["q1"]), loc(d["p1"]),
                                           d["h"], d["t_len"], loc(d["alpha"]), inv_mass,
                                           mesh=mesh))
    out["slot_total"] = int(psum(torch.tensor(SLOT_TOTAL, dtype=torch.int64), mesh))

    # --- each rank bit for bit against a 1-rank run over its chains ----------
    t, init = _funnel_init(torch, PARITY_CHAINS)
    block = slice(r * PARITY_CHAINS // mesh.size, (r + 1) * PARITY_CHAINS // mesh.size)
    solo = solo_mesh("cpu", fold_index=r)
    par = {}
    kw = dict(step_size=0.1, num_steps=4, gamma=1.0, steepness=0.5, num_samples=6,
              burn_in=2, friction_schedule=tanh_schedule, collect_chains_per_device=2)
    a = fs.grahmc_run_sharded(G(2), t, init, mesh, **kw)
    b = fs.grahmc_run_sharded(G(2), t, init[block], solo, **kw)
    par["grahmc"] = (a.samples[:, 2 * r:2 * r + 2], b.samples,
                     a.final_state.position[block], b.final_state.position)
    nkw = dict(step_size=0.2, num_samples=3, steps_per_sample=8, burn_in_steps=8,
               collect_chains_per_device=2)
    for name, extra in (("nuts", {}), ("nuts_multinomial", {"proposal_scheme": "multinomial"}),
                        ("nuts_dense", {"inv_mass_matrix": torch.eye(FUNNEL_DIM) * 1.5})):
        a = fs.nuts_persistent_run_sharded(G(3), t, init, mesh, **nkw, **extra)
        b = fs.nuts_persistent_run_sharded(G(3), t, init[block], solo, **nkw, **extra)
        par[name] = (a.samples[:, 2 * r:2 * r + 2], b.samples,
                     a.info["n_leapfrogs_per_chain"][block], b.info["n_leapfrogs_per_chain"])
        out[f"{name}_slots"] = int(a.info["n_leapfrog_slots"])
    tkw = dict(step_size=0.1, num_steps=4, num_samples=4,
               betas=torch.tensor([1.0, 0.3, 0.08]))
    a = fs.tempered_run_sharded(G(8), t, init, mesh, **tkw)
    b = fs.tempered_run_sharded(G(8), t, init[block], solo, **tkw)
    rows = slice(r * 3 * PARITY_CHAINS // mesh.size, (r + 1) * 3 * PARITY_CHAINS // mesh.size)
    par["tempered"] = (a.samples[:, block], b.samples, a.info["replica_final_positions"][rows],
                       b.info["replica_final_positions"])
    a2 = fs.tempered_run_sharded(G(9), t, init, mesh,
                                 replica_position=a.info["replica_final_positions"], **tkw)
    b2 = fs.tempered_run_sharded(G(9), t, init[block], solo,
                                 replica_position=b.info["replica_final_positions"], **tkw)
    par["tempered_continued"] = (a2.samples[:, block], b2.samples,
                                 a2.info["replica_final_positions"][rows],
                                 b2.info["replica_final_positions"])
    out["parity"] = par
    out["temp_replicas"] = a.info["replica_final_positions"]
    out["temp_swaps"] = (a.info["swap_accept_rate"], a.info["swap_attempts"])

    # --- fixed-ladder SMC: the unsharded run's stages ------------------------
    skw = dict(n_particles=256 * mesh.size, dim=FUNNEL_DIM, step_size=0.3, num_steps=4,
               move_steps=2, base_scale=2.0, betas=torch.linspace(0.2, 1.0, 8),
               max_stages=30, value_and_grad_fn=t.value_and_grad_fn, move_backend="fused")
    s = fs.smc_run_sharded(G(9), t.log_prob_fn, mesh, **skw)
    u = smc_run(G(9), t.log_prob_fn, **skw)
    out["smc_fixed"] = {"stages": (s.info["n_stages"], u.info["n_stages"]),
                        "betas": (s.info["betas"], u.info["betas"]),
                        "log_z": (float(s.log_Z), float(u.log_Z)),
                        "weight_sum": float(torch.exp(s.log_weights.double()).sum()),
                        "shape": tuple(s.particles.shape)}

    # --- the statistical runs (N(0, I_4)) -------------------------------------
    tn = get_target("standard_normal", dim=DIM)
    x0 = torch.as_tensor(_normal_init(STAT_CHAINS))
    stats = {}
    stats["grahmc"] = fs.grahmc_run_sharded(G(11), tn, x0, mesh, **GR_KW).samples
    stats["nuts"] = fs.nuts_persistent_run_sharded(G(12), tn, x0, mesh, **NUTS_KW).samples
    stats["tempered"] = fs.tempered_run_sharded(G(13), tn, x0, mesh, **TEMP_KW).samples
    sm = fs.smc_run_sharded(G(14), tn.log_prob_fn, mesh,
                            value_and_grad_fn=tn.value_and_grad_fn, dtype=torch.float64,
                            **SMC_KW)
    stats["smc"] = (sm.particles, sm.log_weights, float(sm.log_Z), float(sm.info["ess"]))
    out["stats"] = stats if r == 0 else None

    # --- the tuners over the mesh, and (rank 0) without it -------------------
    t, init = _funnel_init(torch, TUNE_CHAINS)
    vag = t.value_and_grad_fn
    tune = {}
    w = run_adaptive_warmup("grahmc", t.log_prob_fn, None, init, G(4), mesh=mesh,
                            value_and_grad_fn=vag, backend="fused", **WARM_KW)
    c = run_chees_warmup("hmc", t.log_prob_fn, None, init, G(5), mesh=mesh,
                         value_and_grad_fn=vag, **CHEES_KW)
    cr = chees_run(G(6), t.log_prob_fn, c[2], step_size=c[0],
                   trajectory_length=c[3]["trajectory_length"], num_samples=4,
                   inv_mass_matrix=c[1], value_and_grad_fn=vag, backend="fused", mesh=mesh)
    j = run_chees_warmup("grahmc", t.log_prob_fn, None, init, G(14), mesh=mesh,
                         value_and_grad_fn=vag, schedule_type="tanh", gamma=1.0,
                         gamma_tuner="joint", **CHEES_KW)
    tune["mesh"] = {"step": w[0], "inv_mass": w[1], "pos_shape": tuple(w[2].shape),
                    "gamma": w[3]["gamma"], "chees_step": c[0],
                    "chees_t": c[3]["trajectory_length"], "chees_run": tuple(cr.samples.shape),
                    "joint_step": j[0], "joint_gamma": j[3]["gamma"],
                    "joint_tuner": j[3]["gamma_tuner"],
                    "gathered": bool(torch.equal(all_gather(shard_chains(w[2], mesh), mesh),
                                                 w[2]))}
    if r == 0:
        w = run_adaptive_warmup("grahmc", t.log_prob_fn, None, init, G(4),
                                value_and_grad_fn=vag, backend="fused", **WARM_KW)
        c = run_chees_warmup("hmc", t.log_prob_fn, None, init, G(5),
                             value_and_grad_fn=vag, **CHEES_KW)
        j = run_chees_warmup("grahmc", t.log_prob_fn, None, init, G(14),
                             value_and_grad_fn=vag, schedule_type="tanh", gamma=1.0,
                             gamma_tuner="joint", **CHEES_KW)
        tune["solo"] = {"step": w[0], "inv_mass": w[1], "gamma": w[3]["gamma"],
                        "chees_step": c[0], "chees_t": c[3]["trajectory_length"],
                        "joint_step": j[0], "joint_gamma": j[3]["gamma"]}
    out["tune"] = tune
    return out


# ----------------------------------------------------------------------------
# Fixtures: the ranks' results and the JAX side
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh():
    from mcmc_tpu.parallel import make_mesh
    return make_mesh(WORLD)


@pytest.fixture(scope="module")
def runs(jax_mesh):
    """Start the ranks, compute the JAX side while they run, then wait."""
    from mcmc_tpu_torch.parallel.launch import RankRun
    started = RankRun(f"{os.path.abspath(__file__)}:_cases", WORLD, device="cpu",
                      timeout=120)
    try:
        jax_side = {"collectives": _jax_collectives(jax_mesh),
                    "stats": _jax_stats(jax_mesh)}
    finally:
        ranks = started.results()
    return ranks, jax_side


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_collectives(runs):
    return runs[1]["collectives"]


@pytest.fixture(scope="module")
def jax_stats(runs):
    return runs[1]["stats"]


def _shard_mapped(mesh, fn, n_args):
    from jax.sharding import PartitionSpec as P
    from mcmc_tpu.parallel import CHAIN_AXIS, shard_map_fn
    return shard_map_fn(fn, mesh, in_specs=(P(CHAIN_AXIS),) * n_args, out_specs=P())


def _jax_collectives(jax_mesh):
    import jax.numpy as jnp
    from mcmc_tpu.samplers.smc import _lse, _rel_ess
    from mcmc_tpu.tuning.adaptation import _persistent_accept_stat
    from mcmc_tpu.tuning.chees import chees_log_t_grad
    from mcmc_tpu.tuning.welford import (dense_moment_init, dense_moment_update,
                                         psum_increment)
    from jax import lax
    d = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in _collective_data().items()}
    ax = "chains"
    old = dense_moment_update(dense_moment_init(d["center"]), d["pos"][:4])
    out = {
        "lse": _shard_mapped(jax_mesh, lambda x: _lse(x, ax), 1)(d["x"]),
        "rel_ess": _shard_mapped(jax_mesh, lambda w: _rel_ess(w, 64, ax), 1)(d["lw"]),
        "dense_moments": _shard_mapped(
            jax_mesh, lambda p: tuple(psum_increment(dense_moment_update(old, p), old, ax)),
            1)(d["pos"]),
        "persistent_stat": _shard_mapped(
            jax_mesh, lambda a, t: _persistent_accept_stat(a, t, axis_name=ax), 2)(
                d["d_alpha"], d["d_trans"]),
        # sequential's _gmean: the pmean of each shard's mean
        "gmean": _shard_mapped(jax_mesh, lambda a: lax.pmean(jnp.mean(a), ax), 1)(
            d["accept"].T),
    }
    for name, inv_mass in (("chees_diag", d["inv_mass"]), ("chees_dense", d["dense"])):
        out[name] = _shard_mapped(
            jax_mesh, lambda q0, q1, p1, al, im=inv_mass: chees_log_t_grad(
                q0, q1, p1, d["h"], d["t_len"], al, im, axis_name=ax), 4)(
                    d["q0"], d["q1"], d["p1"], d["alpha"])
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else float(v))
            for k, v in out.items()}


def _jax_stats(jax_mesh):
    import jax.numpy as jnp
    from jax import random
    from mcmc_tpu.parallel.fused_sharded import (grahmc_run_sharded,
                                                 nuts_persistent_run_sharded,
                                                 smc_run_sharded, tempered_run_sharded)
    from mcmc_tpu.targets import get_target
    t = get_target("standard_normal", dim=DIM)
    x0 = jnp.asarray(_normal_init(STAT_CHAINS))
    out = {
        "grahmc": grahmc_run_sharded(random.PRNGKey(11), t, x0, jax_mesh, **GR_KW).samples,
        "nuts": nuts_persistent_run_sharded(random.PRNGKey(12), t, x0, jax_mesh,
                                            **NUTS_KW).samples,
        "tempered": tempered_run_sharded(random.PRNGKey(13), t, x0, jax_mesh,
                                         **TEMP_KW).samples,
    }
    sm = smc_run_sharded(random.PRNGKey(14), t.log_prob_fn, jax_mesh,
                         value_and_grad_fn=t.value_and_grad_fn, **SMC_KW)
    out = {k: np.asarray(v) for k, v in out.items()}
    out["smc"] = (np.asarray(sm.particles), np.asarray(sm.log_weights), float(sm.log_Z),
                  float(sm.info["ess"]))
    return out


# ----------------------------------------------------------------------------
# The collective math against the JAX package's shard_map, float64
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lse", "rel_ess", "persistent_stat", "gmean",
                                  "chees_diag", "chees_dense"])
def test_collective_matches_shard_map(ranks, jax_collectives, name):
    want = jax_collectives[name]
    for res in ranks:
        assert abs(res[name] - want) <= TOL * max(1.0, abs(want)), (name, res[name], want)


def test_psum_increment_matches_shard_map(ranks, jax_collectives):
    for res in ranks:
        for mine, theirs in zip(res["dense_moments"], jax_collectives["dense_moments"]):
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=TOL, atol=TOL)


def test_the_slot_total_where_jax_wraps(ranks, jax_mesh):
    """The JAX package's sharded persistent NUTS psums uint32 slot counts
    (chosen from one shard's total, fused_sharded.py:369): two shards of
    3e9 slots wrap past 2^32. The port sums int64: the recorded difference
    is exactly 2^32."""
    import jax.numpy as jnp
    from jax import lax
    wrapped = _shard_mapped(jax_mesh, lambda c: lax.psum(c[0], "chains"), 1)(
        jnp.full(WORLD, SLOT_TOTAL, jnp.uint32))
    for res in ranks:
        assert res["slot_total"] == WORLD * SLOT_TOTAL
        assert res["slot_total"] - int(wrapped) == 2 ** 32


# ----------------------------------------------------------------------------
# Within the port: ranks against 1-rank runs, the continuation, SMC
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["grahmc", "nuts", "nuts_multinomial", "nuts_dense",
                                  "tempered", "tempered_continued"])
@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_equals_a_one_rank_run(ranks, name, rank):
    mesh_samples, solo_samples, mesh_more, solo_more = ranks[rank]["parity"][name]
    assert torch.equal(mesh_samples, solo_samples)
    assert torch.equal(mesh_more, solo_more)


def test_results_are_gathered_alike_on_every_rank(ranks):
    for name in ("grahmc", "tempered"):
        # rank r's block of the gathered samples is its own run, and both
        # ranks hold the same gathered arrays
        assert ranks[0]["parity"][name][0].shape == ranks[1]["parity"][name][0].shape
    assert torch.equal(ranks[0]["temp_replicas"], ranks[1]["temp_replicas"])
    for a, b in zip(ranks[0]["temp_swaps"], ranks[1]["temp_swaps"]):
        assert torch.equal(a, b)
    for name in ("nuts", "nuts_multinomial", "nuts_dense"):
        assert ranks[0][f"{name}_slots"] == (8 + 3 * 8) * PARITY_CHAINS


def test_replica_layout_round_trips(ranks):
    """interop.replica_position_from_numpy: the same mesh size keeps the
    rows, a round trip through another size returns them."""
    rows = ranks[0]["temp_replicas"].numpy()
    same = replica_position_from_numpy(rows, 3, WORLD, WORLD, device="cpu").numpy()
    assert np.array_equal(same, rows)
    one = replica_position_from_numpy(rows, 3, WORLD, 1, device="cpu").numpy()
    back = replica_position_from_numpy(one, 3, 1, WORLD, device="cpu").numpy()
    assert np.array_equal(back, rows) and not np.array_equal(one, rows)
    # rung k of chain c sits at k * C + c in the one-rank layout
    local = PARITY_CHAINS // WORLD
    np.testing.assert_array_equal(one[PARITY_CHAINS + local], rows[3 * local + local])


def test_jax_continuation_feeds_the_port(jax_mesh):
    """The JAX package's sharded tempering continuation, laid out by interop
    for the port's mesh, is rank r's replica rows of the JAX run; and the
    machine state of rank r is its block of the JAX machine's."""
    import jax.numpy as jnp
    from jax import random
    from mcmc_tpu.parallel.fused_sharded import tempered_run_sharded
    from mcmc_tpu.samplers.nuts_persistent import _init_pstate
    from mcmc_tpu.targets import get_target
    t = get_target("standard_normal", dim=DIM)
    x0 = jnp.asarray(_normal_init(8))
    res = tempered_run_sharded(random.PRNGKey(0), t, x0, jax_mesh, step_size=0.3,
                               num_steps=2, num_samples=2, n_temps=3)
    rfp = np.asarray(res.info["replica_final_positions"])
    port = replica_position_from_numpy(rfp, 3, WORLD, WORLD, device="cpu")
    assert np.array_equal(port.numpy(), rfp)
    one = replica_position_from_numpy(rfp, 3, WORLD, 1, device="cpu").numpy()
    np.testing.assert_array_equal(one[:8], np.asarray(res.final_state.position))
    lp, grad = t.value_and_grad_fn(x0)
    fields = {k: np.asarray(v) for k, v in _init_pstate(x0, lp, grad, lp.dtype)._asdict().items()
              if v is not None}
    for r in range(WORLD):
        ps = nuts_state_for_rank(r, WORLD, device="cpu", **fields)
        np.testing.assert_array_equal(ps.q.numpy(), fields["q"][4 * r:4 * (r + 1)])


def test_fixed_ladder_smc_takes_the_unsharded_stages(ranks):
    for res in ranks:
        s = res["smc_fixed"]
        assert s["stages"][0] == s["stages"][1] == 8
        assert torch.equal(s["betas"][0], s["betas"][1])
        assert abs(s["log_z"][0] - s["log_z"][1]) < 0.5        # the dryrun's MC bound
        assert abs(s["weight_sum"] - 1.0) < 1e-4
        assert s["shape"] == (512, FUNNEL_DIM)
    assert ranks[0]["smc_fixed"]["log_z"][0] == ranks[1]["smc_fixed"]["log_z"][0]


# ----------------------------------------------------------------------------
# The sharded runs against the JAX sharded runs, statistically
# ----------------------------------------------------------------------------

def _mean_mcse(samples: np.ndarray):
    x = torch.as_tensor(np.asarray(samples, np.float64))
    ess = tdiag.ess_bulk(x).numpy()
    flat = x.reshape(-1, x.shape[-1]).numpy()
    return flat.mean(0), flat.std(0) / np.sqrt(ess), tdiag.split_rhat(x).numpy()


@pytest.mark.parametrize("name", ["grahmc", "nuts", "tempered"])
def test_sharded_run_agrees_with_jax(ranks, jax_stats, name):
    mine = ranks[0]["stats"][name].numpy()
    theirs = jax_stats[name]
    assert mine.shape == theirs.shape
    m1, s1, r1 = _mean_mcse(mine)
    m2, s2, r2 = _mean_mcse(theirs)
    assert np.all(np.abs(m1 - m2) <= 4.0 * np.hypot(s1, s2)), (m1, m2, s1, s2)
    assert r1.max() <= 1.05 and r2.max() <= 1.05, (r1, r2)


def test_sharded_smc_agrees_with_jax(ranks, jax_stats):
    def moments(particles, log_weights, ess):
        w = np.exp(log_weights - log_weights.max())
        w = w / w.sum()
        mean = w @ particles
        var = w @ (particles - mean) ** 2
        return mean, np.sqrt(var / ess)
    p, lw, log_z, ess = ranks[0]["stats"]["smc"]
    m1, s1 = moments(p.numpy(), lw.numpy(), ess)
    p2, lw2, log_z2, ess2 = jax_stats["smc"]
    m2, s2 = moments(p2.astype(np.float64), lw2.astype(np.float64), ess2)
    assert np.all(np.abs(m1 - m2) <= 4.0 * np.hypot(s1, s2)), (m1, m2)
    assert abs(log_z) < 0.2 and abs(log_z2) < 0.2 and abs(log_z - log_z2) < 0.5


# ----------------------------------------------------------------------------
# The tuners over the mesh
# ----------------------------------------------------------------------------

def test_tuned_values_are_the_same_on_every_rank(ranks):
    a, b = ranks[0]["tune"]["mesh"], ranks[1]["tune"]["mesh"]
    for key in ("step", "gamma", "chees_step", "chees_t", "joint_step", "joint_gamma"):
        assert a[key] == b[key], key
    assert torch.equal(a["inv_mass"], b["inv_mass"])
    assert a["pos_shape"] == (TUNE_CHAINS, FUNNEL_DIM) and a["gathered"]
    assert a["chees_run"] == (4, TUNE_CHAINS, FUNNEL_DIM)
    assert a["joint_tuner"] == "joint"


def test_mesh_tuners_land_near_the_unsharded_ones(ranks):
    """The dryrun's bounds (__graft_entry__.py): step ratio < 0.3, mass
    ratio < 2.4, ChEES's log T and step ratios < 0.35, the joint tuner's
    log gamma ratio < 1.0 and step ratio < 0.35."""
    m, s = ranks[0]["tune"]["mesh"], ranks[0]["tune"]["solo"]
    assert abs(math.log(m["step"] / s["step"])) < 0.3
    assert float(torch.max(torch.abs(torch.log(m["inv_mass"] / s["inv_mass"])))) < 2.4
    assert abs(math.log(m["chees_t"] / s["chees_t"])) < 0.35
    assert abs(math.log(m["chees_step"] / s["chees_step"])) < 0.35
    assert abs(math.log(m["joint_gamma"] / s["joint_gamma"])) < 1.0
    assert abs(math.log(m["joint_step"] / s["joint_step"])) < 0.35


def test_only_rank_zero_writes(ranks):
    assert [res["writer"] for res in ranks] == [True, False]
