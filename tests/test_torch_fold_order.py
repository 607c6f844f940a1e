"""Kernel 1's and 1b's lane groups keep the warp-per-chain sum order
(csrc/targets.cuh:chain_sum): a group of G lanes holds one chain, lane j
standing for the warp-per-chain lanes j + G m (m < 32 / G). The lane sums
each such lane's registers in turn, folds those 32 / G partials in
registers along the butterfly's levels 16, ..., G, then runs the levels
G / 2, ..., 1 over the group. Modelled here in PyTorch and held, bit for
bit, to ops/padded_targets.py:warp_order_sum, the order of the
warp-per-chain kernels and of the plain versions.
"""

import math

import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from mcmc_tpu_torch.ops.padded_targets import warp_order_sum  # noqa: E402

SPECIAL = [0.0, -0.0, math.inf, -math.inf, 1e-45, -1e-45, 1.1754942e-38, -2.9e-39, 3.4e38,
           -3.4e38, 1.0, -1.0]
# any float32 but NaN, values of one scale (where the order of the adds
# shows in the rounding) and the special values
VALUES = st.one_of(st.floats(width=32, allow_nan=False), st.floats(-8.0, 8.0, width=32),
                   st.sampled_from(SPECIAL))


def folded_sum(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """Row sums of x (C, D) as a group of `lanes` lanes forms them: each
    lane's partial of every warp-per-chain lane it stands for (that lane's
    entries j, j + 32, ... in turn), the register fold, the butterfly."""
    n_chains, n = x.shape
    per_lane = -(-n // 32)
    padded = torch.zeros((n_chains, 32 * per_lane), dtype=x.dtype)
    padded[:, :n] = x
    rows = padded.reshape(n_chains, per_lane, 32)        # [chain, register, warp lane]
    partial = rows[:, 0]
    for r in range(1, per_lane):
        partial = partial + rows[:, r]
    stand_for = 32 // lanes
    part = [partial[:, [j + lanes * m for j in range(lanes)]] for m in range(stand_for)]
    w = stand_for // 2
    while w:                                             # offsets 16, ..., lanes
        part = [part[m] + part[m + w] for m in range(w)]
        w //= 2
    v = part[0]                                          # [chain, group lane]
    idx = torch.arange(lanes)
    off = lanes // 2
    while off:                                           # offsets lanes / 2, ..., 1
        v = v + v[:, idx ^ off]
        off //= 2
    return v[:, 0]


@st.composite
def rows(draw):
    dim = draw(st.integers(1, 128))
    chains = draw(st.integers(1, 3))
    values = draw(st.lists(VALUES, min_size=dim * chains, max_size=dim * chains))
    x = torch.tensor(values, dtype=torch.float32).reshape(chains, dim)
    return x


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@settings(max_examples=50, deadline=None, database=None)
@given(x=rows())
def test_fold_keeps_the_warp_order_bit_for_bit(lanes, x):
    want = warp_order_sum(x, 32)
    got = folded_sum(x, lanes)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (got, want)


@pytest.mark.parametrize("lanes", [4, 8, 16])
def test_fold_of_padding_keeps_the_sign_of_zero(lanes):
    """Rows of -0.0: the warp order keeps -0.0 where only -0.0 meet and
    gives +0.0 where a zero past D (+0.0) joins them; the fold gives the
    same bits at every D."""
    for dim in (1, 9, 32, 33, 50, 128):
        x = torch.full((2, dim), -0.0)
        want = warp_order_sum(x, 32)
        assert torch.equal(folded_sum(x, lanes).view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_fold_on_rows_of_one_scale(lanes):
    """Seeded normal rows at every D of the kernels (1-128), where almost
    any other order of the adds rounds differently."""
    g = torch.Generator().manual_seed(lanes)
    x = torch.randn((64, 128), generator=g)
    for dim in range(1, 129):
        want = warp_order_sum(x[:, :dim], 32)
        got = folded_sum(x[:, :dim], lanes)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), dim
