"""Kernel 4's plain window on the L1 families at the shell counts and
shapes that tests/test_torch_rahmc.py does not run (1, 3, 5 and 8 shells,
8 = csrc/targets.cuh:MAX_SHELLS; D 2 and 10), against the JAX package's
Pallas window in interpret mode, on the JAX window's injected draws.

The CUDA window spreads these families' shells over a warp's lanes and
masks a shell past the target's count with a select; its plain version
(ops/fused_nuts.py:nuts_window_plain) is what tests/test_torch_cuda.py holds
it to bit for bit on the card, and what this file holds to the JAX window.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.ops import fused_nuts as jfn  # noqa: E402
from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers.nuts_persistent import _init_pstate as j_init_pstate  # noqa: E402
from mcmc_tpu.targets import rahmc_paper as jr  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch.ops import fused_nuts as fn  # noqa: E402
from mcmc_tpu_torch.ops import padded_targets as pt  # noqa: E402
from mcmc_tpu_torch.targets import rahmc_paper as tr  # noqa: E402

F32 = jnp.float32
C = 16
RADII = (4.0, 8.0, 16.0, 24.0, 32.0, 40.0, 48.0, 56.0)
STEP = {"concentric_l1_balls": 0.4, "nested_l1_balls": 0.5}
# test_torch_rahmc.py runs the concentric shells (3) at D 3 and the nested
# ones (5) at D 2
CASES = [(f, n, d) for f in STEP for n in (1, 3, 5, 8) for d in (2, 10)
         if (f, n, d) != ("nested_l1_balls", 5, 2)]


def _pair(family, n_shells, dim):
    """(JAX target, port target) of `family` with `n_shells` shells."""
    if family == "concentric_l1_balls":
        return (jr.concentric_l1_balls(dim, radii=RADII[:n_shells]),
                tr.concentric_l1_balls(dim=dim, radii=RADII[:n_shells]))
    return (jr.nested_l1_balls(dim, n_inner=n_shells - 1),
            tr.nested_l1_balls(dim=dim, n_inner=n_shells - 1))


def _positions(n_shells, dim, seed):
    """Float32 points on the shells' radii (and near the nested centres)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((C, dim))
    d /= np.abs(d).sum(axis=1, keepdims=True)
    r = rng.choice((2.0,) + RADII[:n_shells] + (20.0,), size=C)
    return (d * r[:, None] + 0.5 * rng.standard_normal((C, dim))).astype(np.float32)


@pytest.mark.parametrize("family,n_shells,dim", CASES)
def test_plain_window_on_the_shells_matches_pallas(family, n_shells, dim):
    """W = 4, 12 iterations, depth 6, endpoint scheme, unit metric: the
    discrete state equal and the emitted state within 2e-4 on every chain
    (test_torch_rahmc.py's kernel-4 tolerance: the two sum the shells' L1
    norms in another order, float32); the trajectory in flight within 2e-4
    on all chains but at most one of the 16, whose in-flight subtree may
    drift: an ulp of the L1 norm moves the gradient's sign jumps (8 shells
    at D 10 read one such chain, 0.016 off, its emitted state within
    2e-4)."""
    from test_torch_nuts import _DISCRETE, _jax_draws, _port_draws, _unpack
    jtarget, target = _pair(family, n_shells, dim)
    assert len(pt.device_shells(target.value_and_grad_fn.kernel_info)) == n_shells
    s = jbase.init_chain_state(jnp.asarray(_positions(n_shells, dim, n_shells + dim)),
                               jtarget.log_prob_fn, jtarget.value_and_grad_fn)
    q0, lp0, g0 = (x.astype(F32) for x in (s.position, s.log_prob, s.grad_log_prob))
    n_iters, depth, w = 12, 6, 4
    step = STEP[family]
    key = random.PRNGKey(n_shells)
    window = jfn.make_fused_nuts_window(jtarget.value_and_grad_fn, n_iters, depth, C, dim,
                                        interpret=True, steps_per_iter=w)
    ts = window(key, jfn.pack_state(q0, lp0, g0, jfn._round_up(dim, jfn.SUBLANE)), step,
                jnp.ones(dim, F32))
    ps0 = j_init_pstate(q0, lp0, g0, F32)
    state = interop.nuts_state_from_numpy(device="cpu", **{
        k: np.asarray(v) for k, v in ps0._asdict().items() if v is not None})
    out = fn.nuts_window_kernel(target.value_and_grad_fn.kernel_info, n_iters, w, depth, state,
                                fn.nuts_scalars(step, 1000.0, "cpu"), torch.ones(dim),
                                draws=_port_draws(_jax_draws(key, dim, n_iters)))
    jax_fields = _unpack(ts, dim)
    for name in _DISCRETE + ("n_exec",):
        np.testing.assert_array_equal(getattr(out, name).numpy().astype(np.float64),
                                      np.asarray(jax_fields[name]).astype(np.float64),
                                      err_msg=name)
    for name in ("q", "q_res", "lp", "lp_res", "alpha_acc"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(jax_fields[name]),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    drifted = np.zeros(C, bool)
    for name in ("q_c", "q_l", "q_r"):
        a, b = getattr(out, name).numpy(), np.asarray(jax_fields[name])
        drifted |= ~np.isclose(a, b, rtol=2e-4, atol=2e-4).all(axis=1)
    assert drifted.sum() <= 1, (np.flatnonzero(drifted), family, n_shells, dim)
    assert int(out.transitions.sum()) > 0
