"""The geometry of kernel 1's block-tiled variants 1a and 1d
(ops/fused_trajectory.py:tile_geometry, csrc/tiled_step.cuh): blocks for
ragged chain counts, the shared memory under an H100 block's limit for
every D the kernels take, the X row tiles, and the ValueError past a
limit. The kernel itself runs only on the card (tests/test_torch_cuda.py);
its plain versions are held against the JAX package in
test_torch_dense_grahmc.py and test_torch_hierarchical.py."""

import math

import pytest

torch = pytest.importorskip("torch")

from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402


@pytest.mark.parametrize("n_data,chains", [(0, ft.DENSE_TILE_CHAINS),
                                           (256, ft.HIER_TILE_CHAINS)])
@pytest.mark.parametrize("n_chains", [1, 7, 9, 31, 32, 33, 8191, 8192, 65536])
def test_blocks_cover_ragged_chain_counts(n_chains, n_data, chains):
    """1a's blocks hold DENSE_TILE_CHAINS chains, 1d's HIER_TILE_CHAINS."""
    geo = ft.tile_geometry(n_chains, 50, n_data, dense=True)
    assert geo.chains == chains
    assert geo.blocks == math.ceil(n_chains / chains)
    assert (geo.blocks - 1) * geo.chains < n_chains <= geo.blocks * geo.chains


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("n_data", [0, 1, 50, 256, 1000])
def test_shared_memory_fits_a_block_for_every_dim(dense, n_data):
    for dim in range(1, ft.MAX_DIM + 1):
        geo = ft.tile_geometry(8192, dim, n_data, dense)
        assert 0 < geo.smem_bytes <= ft.MAX_TILE_SMEM == 232_448
        assert geo.smem_bytes % 16 == 0
        if n_data:
            assert geo.row_tile in ft.TILE_ROWS
            # the largest row tile that fits is taken
            bigger = [r for r in ft.TILE_ROWS if r > geo.row_tile]
            assert all(ft._tile_bytes(dim, dense, r, geo.chains) > ft.MAX_TILE_SMEM
                       for r in bigger)
        else:
            assert geo.row_tile == geo.row_tiles == 0


def test_config_5_and_the_dense_row_shapes():
    """Config 5's 1d (8,192 x 100, 256 rows: four tiles of 64) and the
    dense-warmup row's 1a (65,536 x 50, no data), byte for byte as
    tiled_step.cuh:tile_layout counts them."""
    hier = ft.tile_geometry(8192, 100, 256, dense=False)
    assert (hier.blocks, hier.row_tile, hier.row_tiles) == (256, 64, 4)
    dp, ps = 100, 32 + 4
    assert hier.smem_bytes == 4 * (100 * ps + 32 * dp + 2 * 100 * 64 + 2 * 64 * dp + 64 * ps)
    dense = ft.tile_geometry(65536, 50, 0, dense=True)
    assert dense.blocks == 65536 // 8
    assert dense.smem_bytes == 4 * (2 * 50 * 52 + 50 * (8 + 4) + 8 * 52)


@pytest.mark.parametrize("dim,n_data,dense,rows,tiles", [
    (100, 256, False, 64, 4), (100, 257, False, 64, 5), (100, 50, True, 64, 1),
    (9, 1000, False, 64, 16), (128, 33, True, 16, 3), (128, 1000, True, 16, 63),
    (128, 100, False, 64, 2)])
def test_row_tiles_for_n_data_off_the_tile(dim, n_data, dense, rows, tiles):
    geo = ft.tile_geometry(4096, dim, n_data, dense)
    assert (geo.row_tile, geo.row_tiles) == (rows, tiles)
    assert (geo.row_tiles - 1) * geo.row_tile < n_data <= geo.row_tiles * geo.row_tile


@pytest.mark.parametrize("kwargs,limit", [
    (dict(n_chains=1, dim=129), "dim <= 128"),
    (dict(n_chains=1, dim=0), "dim <= 128"),
    (dict(n_chains=0, dim=10), "at least one chain"),
    (dict(n_chains=8, dim=10, n_data=-1), "n_data must be >= 0"),
])
def test_shapes_past_a_limit_raise(kwargs, limit):
    with pytest.raises(ValueError, match=limit):
        ft.tile_geometry(**kwargs)


def test_the_smallest_row_tile_fits_at_the_largest_dim():
    """tiled_step.cuh's static_assert: at D = 128 with the dense metric and
    data, 16 rows need 200,960 bytes, under the 232,448 of a block, and the
    larger tiles do not fit."""
    geo = ft.tile_geometry(1, ft.MAX_DIM, 33, True)
    assert (geo.row_tile, geo.smem_bytes) == (min(ft.TILE_ROWS), 200_960)
    assert ft._tile_bytes(ft.MAX_DIM, True, min(ft.TILE_ROWS), ft.HIER_TILE_CHAINS) \
        <= ft.MAX_TILE_SMEM
