"""Kernel 3's block-tiled 3a (csrc/fused_rwmh.cu:rwmh_tiled_kernel) on the
CPU: its geometry (ops/fused_rwmh.py:tile_geometry) -- blocks for ragged
chain counts, X^T's row tiles, shared memory under an H100 block's limit
for every D the kernel takes, a ValueError past each limit --, and the
plain version on chains split into blocks, which the tile relies on: no
chain's result depends on another's. The kernel itself runs only on the
card (tests/test_torch_cuda.py -k tiled_rwmh); its plain version is held
against the JAX package in test_torch_rwmh.py."""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcmc_tpu_torch.ops import fused_rwmh as fr  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.targets import get_target  # noqa: E402


@pytest.mark.parametrize("n_chains", [1, 7, 31, 32, 33, 8191, 8192])
def test_blocks_cover_ragged_chain_counts(n_chains):
    """32 chains a block, one warp each; the last block may be ragged."""
    geo = fr.tile_geometry(n_chains, 100, 256)
    assert geo.chains == ft.HIER_TILE_CHAINS == 32
    assert geo.blocks == math.ceil(n_chains / geo.chains)
    assert (geo.blocks - 1) * geo.chains < n_chains <= geo.blocks * geo.chains


@pytest.mark.parametrize("n_data", [1, 50, 128, 129, 256, 1000])
def test_shared_memory_fits_a_block_for_every_dim(n_data):
    """The block's q transposed, its Z tile and two X^T tiles of 128 rows
    (no X tile, no residuals: the log-density alone) fit an H100 block at
    every D <= 128, on 16 bytes; the largest D takes 165,888 bytes."""
    for dim in range(1, ft.MAX_DIM + 1):
        geo = fr.tile_geometry(8192, dim, n_data)
        assert geo.row_tile == fr.LP_TILE_ROWS == 128
        assert 0 < geo.smem_bytes <= ft.MAX_TILE_SMEM
        assert geo.smem_bytes % 16 == 0
        assert geo.smem_bytes == 4 * (dim * 36 + 32 * 128 + 2 * dim * 128)
    assert fr.tile_geometry(1, ft.MAX_DIM, n_data).smem_bytes == 165_888


def test_config_5_shape():
    """3a at config 5 (8,192 x 100, 256 rows): 256 blocks, two tiles of 128
    rows, 133,184 bytes -- under the gradient form's 1d tile (four tiles of
    64 rows, X and residual tiles besides)."""
    geo = fr.tile_geometry(8192, 100, 256)
    assert (geo.chains, geo.blocks, geo.row_tile, geo.row_tiles) == (32, 256, 128, 2)
    assert geo.smem_bytes == 133_184
    assert geo.smem_bytes < ft.tile_geometry(8192, 100, 256).smem_bytes


@pytest.mark.parametrize("n_data,tiles", [(1, 1), (50, 1), (128, 1), (129, 2), (256, 2),
                                          (257, 3), (1000, 8)])
def test_row_tiles_for_n_data_off_the_tile(n_data, tiles):
    geo = fr.tile_geometry(4096, 20, n_data)
    assert geo.row_tiles == tiles
    assert (geo.row_tiles - 1) * geo.row_tile < n_data <= geo.row_tiles * geo.row_tile


@pytest.mark.parametrize("kwargs,limit", [
    (dict(n_chains=1, dim=129, n_data=256), "dim <= 128"),
    (dict(n_chains=1, dim=0, n_data=256), "dim <= 128"),
    (dict(n_chains=0, dim=10, n_data=256), "at least one chain"),
    (dict(n_chains=8, dim=10, n_data=0), "n_data >= 1"),
    (dict(n_chains=8, dim=10, n_data=-3), "n_data >= 1"),
])
def test_shapes_past_a_limit_raise(kwargs, limit):
    with pytest.raises(ValueError, match=limit):
        fr.tile_geometry(**kwargs)


def test_plain_version_on_blocks_of_chains():
    """The plain 3a on 70 chains equals its run on blocks of 32, 32 and 6
    chains with their draws split the same way, bit for bit: a block's
    chains share X's loads but no result."""
    t = get_target("hierarchical_logistic", dim=9, n_data=50)
    info = t.value_and_grad_fn.kernel_info
    g = torch.Generator().manual_seed(4)
    q = t.init_sampler(g, 70).float()
    lp = t.log_prob_fn(q).float()
    noise = torch.randn((6, 70, 9), generator=g)
    u = torch.rand((6, 70), generator=g).clamp_min(2.0 ** -25)
    scale = fr.rwmh_scale(0.2, "cpu")
    whole = fr.rwmh_multistep_kernel(info, 6, q, lp, scale, 70, noise=noise, u=u)
    parts = [fr.rwmh_multistep_kernel(info, 6, q[a:b], lp[a:b], scale, b - a,
                                      noise=noise[:, a:b].contiguous(),
                                      u=u[:, a:b].contiguous())
             for a, b in ((0, 32), (32, 64), (64, 70))]
    for k, dim in ((0, 0), (1, 0), (2, 1), (3, 1), (4, 1)):
        joined = torch.cat([p[k] for p in parts], dim=dim)
        assert torch.equal(whole[k], joined)
    assert 0.05 < float(whole[2].float().mean()) < 1.0
