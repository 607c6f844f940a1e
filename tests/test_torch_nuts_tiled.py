"""Kernel 4's redesigned form (csrc/nuts_window.cuh) on the CPU: which
target takes which form (ops/fused_nuts.py:window_form), the tiled form's
geometry (tile_geometry) -- blocks for
ragged chain counts, shared memory under an H100 block's limit for every D
the kernel takes, X's row tiles, a ValueError past each limit --, the
lockstep count of blocks of chains (lockstep_counts) on hand-made live
counts, and the plain window on chains split into blocks, which the tile
relies on: no chain's result depends on another's, so blocks of C chains
with their draws split the same way give the whole window bit for bit. The
kernel itself runs only on the card (tests/test_torch_cuda.py -k
tiled_nuts); its plain version is held against the JAX package in
test_torch_nuts.py, test_torch_nuts_multinomial.py, test_torch_dense_nuts.py
and test_torch_hierarchical.py."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmc_tpu_torch.ops import fused_nuts as fn  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import nuts_persistent as tn  # noqa: E402
from mcmc_tpu_torch.targets import get_target  # noqa: E402

FLAG_BYTES = 2 * fn.WINDOW_TILE_CHAINS * 4   # live_tile's two buffers of C ints


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("n_chains", [1, 7, 9, 31, 33, 8191])
def test_blocks_cover_ragged_chain_counts(n_chains, dense):
    """4c's blocks hold WINDOW_TILE_CHAINS chains under either metric; the
    last block may be ragged."""
    geo = fn.tile_geometry(n_chains, 50, 256, dense=dense)
    assert geo.chains == fn.WINDOW_TILE_CHAINS == 32
    assert geo.blocks == math.ceil(n_chains / geo.chains)
    assert (geo.blocks - 1) * geo.chains < n_chains <= geo.blocks * geo.chains


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("n_data", [1, 33, 50, 256, 1000])
def test_shared_memory_fits_a_block_for_every_dim(dense, n_data):
    """Dynamic shared memory and the live-chain flags within 232,448 bytes
    for every D <= 128, with either metric; the largest row tile that fits
    is taken."""
    for dim in range(1, ft.MAX_DIM + 1):
        geo = fn.tile_geometry(8192, dim, n_data, dense)
        assert 0 < geo.smem_bytes
        assert geo.smem_bytes + FLAG_BYTES <= ft.MAX_TILE_SMEM == 232_448
        assert geo.smem_bytes % 16 == 0
        assert geo.row_tile in ft.TILE_ROWS
        bigger = [r for r in ft.TILE_ROWS if r > geo.row_tile]
        assert all(ft._tile_bytes(dim, dense, r, geo.chains) + FLAG_BYTES > ft.MAX_TILE_SMEM
                   for r in bigger)


def test_the_rows_shapes():
    """4c at config 5 (8,192 x 100, 256 rows: four tiles of 64) under either
    metric, byte for byte as tiled_step.cuh:tile_layout counts them at the
    window's chains."""
    hier = fn.tile_geometry(8192, 100, 256, dense=False)
    assert (hier.chains, hier.blocks, hier.row_tile, hier.row_tiles) == (32, 256, 64, 4)
    dp, ps = 100, 32 + 4
    assert hier.smem_bytes == 4 * (100 * ps + 32 * dp + 2 * 100 * 64 + 2 * 64 * dp + 64 * ps)
    dense = fn.tile_geometry(8192, 100, 256, dense=True)
    assert (dense.chains, dense.blocks, dense.row_tile, dense.row_tiles) == (32, 256, 64, 4)
    assert dense.smem_bytes == hier.smem_bytes + 4 * 2 * 100 * dp == 218_816


@pytest.mark.parametrize("dim,n_data,dense,rows,tiles", [
    (100, 256, False, 64, 4), (100, 257, False, 64, 5), (100, 50, True, 64, 1),
    (9, 1000, False, 64, 16), (128, 33, True, 16, 3), (128, 1000, True, 16, 63),
    (128, 100, False, 64, 2), (20, 50, True, 64, 1)])
def test_row_tiles_for_n_data_off_the_tile(dim, n_data, dense, rows, tiles):
    geo = fn.tile_geometry(4096, dim, n_data, dense)
    assert (geo.row_tile, geo.row_tiles) == (rows, tiles)
    assert (geo.row_tiles - 1) * geo.row_tile < n_data <= geo.row_tiles * geo.row_tile


def test_the_smallest_row_tile_fits_at_the_largest_dim():
    """nuts_window.cuh's static_assert: at D = 128 with the dense metric and
    data, 16 rows need 200,960 bytes and 256 of flags, under the 232,448 of
    a block; the larger tiles do not fit."""
    geo = fn.tile_geometry(1, ft.MAX_DIM, 33, True)
    assert (geo.row_tile, geo.smem_bytes) == (min(ft.TILE_ROWS), 200_960)
    for rows in ft.TILE_ROWS[:-1]:
        assert ft._tile_bytes(ft.MAX_DIM, True, rows, 32) + FLAG_BYTES > ft.MAX_TILE_SMEM


@pytest.mark.parametrize("kwargs,limit", [
    (dict(n_chains=1, dim=129, n_data=256), "dim <= 128"),
    (dict(n_chains=1, dim=0, n_data=256), "dim <= 128"),
    (dict(n_chains=0, dim=10, n_data=256), "at least one chain"),
    (dict(n_chains=8, dim=10, n_data=-1), "n_data >= 1"),
    (dict(n_chains=8, dim=10, n_data=0), "n_data >= 1"),
])
def test_shapes_past_a_limit_raise(kwargs, limit):
    with pytest.raises(ValueError, match=limit):
        fn.tile_geometry(**kwargs)


@pytest.mark.parametrize("family,dim,dense,form", [
    ("standard_normal", 10, False, "warp"), ("neals_funnel", 128, False, "warp"),
    ("standard_normal", 10, True, "warp"), ("rosenbrock", 64, True, "warp"),
    ("correlated_gaussian", 65, True, "warp"), ("standard_normal", 128, True, "warp"),
    ("hierarchical_logistic", 10, False, "tiled"), ("hierarchical_logistic", 10, True, "tiled")])
def test_each_variant_takes_its_form(family, dim, dense, form):
    """Every family without data runs warp per chain under either metric
    and at every D (4, 4a, 4b, 4a+4b); the data-carrying target (4c, 4a's
    and 4b's data forms) block-tiled. The form follows the family alone,
    so `dense` only names the variant."""
    kw = {"n_data": 20} if family == "hierarchical_logistic" else {}
    t = get_target(family, dim=dim, **kw)
    assert fn.window_form(t.value_and_grad_fn.kernel_info) == form
    assert (form == "tiled") == (family == "hierarchical_logistic")


def test_lockstep_counts_lockstep_blocks():
    """Two iterations of five chains in blocks of two (the last ragged):
    per iteration a block runs the most slots of its chains."""
    live = torch.tensor([[4, 1, 0, 2, 3],
                         [1, 1, 1, 1, 0]])
    starts = torch.tensor([[True, False, False, False, False],
                           [False, False, True, True, False]])
    c = fn.lockstep_counts(live, starts, 2)
    assert c == fn.LockstepCounts(chain_slots=14, block_slots=2 * (4 + 2 + 3 + 1 + 1 + 0),
                                  chain_starts=3, start_blocks=2)
    assert c.slot_share == pytest.approx(14 / 22)


@pytest.mark.parametrize("chains", [1, 4, 8, 32])
def test_lockstep_counts_of_chains_in_step(chains):
    """Chains that all run the same slots lose nothing but a ragged last
    block's missing chains; one block of one chain loses nothing at all."""
    live = torch.full((16, 64), 3)
    starts = torch.zeros((16, 64), dtype=torch.bool)
    starts[5, 0] = True
    c = fn.lockstep_counts(live, starts, chains)
    assert (c.chain_slots, c.block_slots) == (16 * 64 * 3, 16 * 64 * 3)
    assert (c.chain_starts, c.start_blocks) == (1, 1)
    ragged = fn.lockstep_counts(live[:, :63], starts[:, :63], chains)
    assert ragged.block_slots == (16 * 64 * 3 if chains > 1 else 16 * 63 * 3)


def test_lockstep_counts_of_one_live_chain_a_block():
    """One live chain in each block of 8: the blocks run 8 warp-slots for
    each slot a chain needs."""
    live = torch.zeros((4, 32), dtype=torch.int64)
    live[:, ::8] = 4
    c = fn.lockstep_counts(live, torch.zeros((4, 32), dtype=torch.bool), 8)
    assert c.slot_share == pytest.approx(1 / 8)
    assert c.start_blocks == 0


def _window_inputs(family, dense, multinomial, n, seed):
    """A state one plain window in, its scalars, metric and a window's
    injected draws (8 iterations x W = 4), made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    if family == "hierarchical_logistic":
        dim = 5
        t = get_target(family, dim=dim, n_data=16)
        q = torch.from_numpy(rng.normal(0.0, 0.3, (n, dim)).astype(np.float32))
        step = 0.4
    else:
        dim = 6
        t = get_target(family, dim=dim, correlation=0.5)
        q = torch.from_numpy(rng.normal(0.0, 0.5, (n, dim)).astype(np.float32))
        step = 0.3
    info = t.value_and_grad_fn.kernel_info
    lp, grad = t.value_and_grad_fn(q)
    if dense:
        a = rng.normal(size=(dim, dim))
        metric = torch.from_numpy(a @ a.T / dim + 0.5 * np.eye(dim))
    else:
        metric = torch.from_numpy(rng.uniform(0.5, 1.5, dim).astype(np.float32))
    inv_mass, l_inv = ft.kernel_metric(metric)
    scalars = fn.nuts_scalars(step, 1000.0, "cpu")
    start = tn._init_pstate(q, lp.float(), grad.float(), torch.float32, multinomial=multinomial)
    key = torch.tensor([3, 4], dtype=torch.int32)
    warm = fn.nuts_window_plain(info, 4, 4, 10, start, scalars, inv_mass, key=key, call=0,
                                l_inv=l_inv)
    it, slots = 8, 4
    draws = (torch.from_numpy(rng.normal(size=(it, n, dim)).astype(np.float32)),
             torch.from_numpy(rng.uniform(size=(it, n)) < 0.5),
             torch.from_numpy(rng.uniform(size=(it, n)) < 0.5),
             torch.from_numpy(rng.uniform(size=(it, n)).astype(np.float32)),
             torch.from_numpy(rng.uniform(2.0 ** -25, 1.0, size=(it * (slots if multinomial
                                                                       else 1), n))
                              .astype(np.float32)),
             torch.from_numpy(rng.uniform(size=(it, n)).astype(np.float32)))
    return info, warm, scalars, inv_mass, l_inv, draws, (it, slots)


def _rows(state, lo, hi):
    return tn._PState(*(None if t is None else t[lo:hi].clone() for t in state))


@pytest.mark.parametrize("multinomial", [False, True])
@pytest.mark.parametrize("family,dense", [("correlated_gaussian", True),
                                          ("hierarchical_logistic", False),
                                          ("hierarchical_logistic", True)])
def test_blocks_of_chains_give_the_whole_window(family, dense, multinomial):
    """The plain window on 70 chains split into blocks of WINDOW_TILE_CHAINS
    (the last ragged), each block with its rows of the injected draws,
    concatenated: the whole window's state bit for bit (4b, 4c and 4c's
    dense form, both schemes)."""
    n, c = 70, fn.WINDOW_TILE_CHAINS
    info, warm, scalars, inv_mass, l_inv, draws, (it, slots) = _window_inputs(
        family, dense, multinomial, n, seed=11 + 2 * dense + multinomial)
    whole = fn.nuts_window_plain(info, it, slots, 10, _rows(warm, 0, n), scalars, inv_mass,
                                 draws=draws, l_inv=l_inv)
    parts = [fn.nuts_window_plain(info, it, slots, 10, _rows(warm, lo, lo + c), scalars,
                                  inv_mass, draws=tuple(d[:, lo:lo + c].contiguous()
                                                        for d in draws), l_inv=l_inv)
             for lo in range(0, n, c)]
    assert int((whole.transitions - warm.transitions).sum()) > 0
    for name, t in zip(whole._fields, whole):
        if t is None:
            continue
        joined = torch.cat([getattr(p, name) for p in parts])
        if t.dtype == torch.float32:
            same = (t.view(torch.int32) == joined.view(torch.int32)) | (t.isnan()
                                                                         & joined.isnan())
            assert bool(same.all()), name
        else:
            assert torch.equal(t, joined), name
