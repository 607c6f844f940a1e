"""Kernel 2's block-tiled 2b (csrc/tiled_step.cuh:grahmc_tiled_multistep_kernel,
the hierarchical posterior under either metric) on the CPU: its geometry,
which is 1d's (ops/fused_trajectory.py:tile_geometry) -- blocks for ragged
chain counts, X's row tiles, shared memory under an H100 block's limit for
every D the kernel takes with 256 data rows, config 5's 4,096-chain shape
--, and the plain multistep version on chains split into blocks of
HIER_TILE_CHAINS, which the tile relies on: no chain's result depends on
another's, and a block's rows past its live chains (the zero rows a warp
past n_chains runs on) change nothing. The kernel itself runs only on the
card (tests/test_torch_cuda.py -k tiled_multistep); its plain version is
held against the JAX package in test_torch_hierarchical.py."""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.targets import get_target  # noqa: E402

HIER = "hierarchical_logistic"


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("n_chains", [1, 7, 31, 32, 33, 4095, 4096, 4099])
def test_blocks_cover_ragged_chain_counts(n_chains, dense):
    """32 chains a block, one warp each; the last block may be ragged."""
    geo = ft.tile_geometry(n_chains, 100, 256, dense)
    assert geo.chains == ft.HIER_TILE_CHAINS == 32
    assert geo.blocks == math.ceil(n_chains / geo.chains)
    assert (geo.blocks - 1) * geo.chains < n_chains <= geo.blocks * geo.chains


@pytest.mark.parametrize("dense", [False, True])
def test_shared_memory_fits_a_block_for_every_dim(dense):
    """At 256 data rows the largest row tile that fits is taken at every D
    <= 128, under an H100 block's limit, on 16 bytes."""
    for dim in range(1, ft.MAX_DIM + 1):
        geo = ft.tile_geometry(4096, dim, 256, dense)
        assert geo.row_tile in ft.TILE_ROWS
        assert 0 < geo.smem_bytes <= ft.MAX_TILE_SMEM
        assert geo.smem_bytes % 16 == 0
        assert geo.row_tiles == math.ceil(256 / geo.row_tile)
        assert all(ft._tile_bytes(dim, dense, r, geo.chains) > ft.MAX_TILE_SMEM
                   for r in ft.TILE_ROWS if r > geo.row_tile)


def test_config_5_multistep_shape():
    """2b at config 5's multistep shape (HIER_MULTI_CHAINS = 4,096 chains x
    100, 256 rows): 128 blocks, one wave on an H100's 132 SMs, four row
    tiles of 64; 138,816 bytes (the dense form 218,816), byte for byte as
    tiled_step.cuh:tile_layout counts them."""
    diag = ft.tile_geometry(4096, 100, 256, dense=False)
    assert (diag.chains, diag.blocks, diag.row_tile, diag.row_tiles) == (32, 128, 64, 4)
    dp, ps = 100, 32 + 4
    floats = 100 * ps + 32 * dp + 2 * 100 * 64 + 2 * 64 * dp + 64 * ps
    assert diag.smem_bytes == 4 * floats == 138_816
    dense = ft.tile_geometry(4096, 100, 256, dense=True)
    assert (dense.blocks, dense.row_tile, dense.row_tiles) == (128, 64, 4)
    assert dense.smem_bytes == 4 * (floats + 2 * 100 * dp) == 218_816


def _hier_state(dim, n_data, n, seed):
    t = get_target(HIER, dim=dim, n_data=n_data)
    g = torch.Generator().manual_seed(seed)
    q = (t.init_sampler(g, n) * 2.0).float()
    lp, grad = (x.float() for x in t.value_and_grad_fn(q))
    return t.value_and_grad_fn.kernel_info, q, lp, grad, g


def _metric(dense, dim, g):
    if not dense:
        return torch.rand(dim, generator=g) * 0.5 + 0.25, None
    a = torch.randn((dim, dim), generator=g, dtype=torch.float64)
    return ft.prepare_dense_metric(a @ a.T / dim + 0.5 * torch.eye(dim, dtype=torch.float64))


@pytest.mark.parametrize("transitions", [1, 3])
@pytest.mark.parametrize("dense", [False, True])
def test_plain_multistep_on_blocks_of_chains(dense, transitions):
    """The plain 2b on 70 chains equals its run on blocks of 32, 32 and 6
    chains with their draws split the same way, and on a last block of 32
    whose 26 rows past the 6 live chains are zero rows with zero draws,
    bit for bit in every output of the live chains: a block's chains share
    X's loads but no result."""
    dim, n = 9, 70
    info, q, lp, grad, g = _hier_state(dim, 40, n, 5 + transitions)
    invm, l_inv = _metric(dense, dim, g)
    p0 = torch.randn((transitions, n, dim), generator=g)
    if dense:
        p0 = ft.unwhiten(p0.reshape(-1, dim), invm, l_inv).reshape(transitions, n, dim)
    u = torch.rand((transitions, n), generator=g).clamp_min(2.0 ** -25)
    scalars = ft.kernel_scalars(0.3 if dense else 0.6, 0.5, 0.5, "cpu")

    def run(a, b, pad=0):
        def rows(x, axis):
            part = x.narrow(axis, a, b - a)
            if pad:
                shape = list(part.shape)
                shape[axis] = pad
                part = torch.cat([part, part.new_zeros(shape)], dim=axis)
            return part.contiguous()
        zlp, zgrad = rows(lp, 0), rows(grad, 0)
        if pad:      # the zero rows' lp and gradient, as a warp past n_chains loads nothing
            zlp[b - a:], zgrad[b - a:] = 0.0, 0.0
        return ft.grahmc_multistep_kernel(
            info, 4, ft.SCHEDULE_IDS["tanh"], transitions, rows(q, 0), zlp, zgrad, scalars,
            invm, p0=rows(p0, 1), u=rows(u, 1).clamp_min(2.0 ** -25), l_inv=l_inv)

    whole = run(0, n)
    parts = [run(0, 32), run(32, 64), run(64, 70)]
    padded = run(64, 70, pad=26)
    for k, axis in ((0, 0), (1, 0), (2, 0), (3, 1), (4, 1), (5, 1), (6, 1)):
        joined = torch.cat([p[k] for p in parts], dim=axis)
        assert torch.equal(whole[k], joined), k
        live = padded[k].narrow(axis, 0, 6)
        assert torch.equal(whole[k].narrow(axis, 64, 6), live), k
    assert 0.05 < float(whole[3].float().mean()) < 1.0


def test_the_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    """On CPU tensors the wrapper runs grahmc_multistep_plain (bit for bit)
    and counts no launch of 2b."""
    info, q, lp, grad, g = _hier_state(12, 33, 40, 3)
    invm = torch.ones(12)
    key = torch.tensor([3, 4], dtype=torch.int32)
    args = (info, 3, ft.SCHEDULE_IDS["constant"], 2, q, lp, grad,
            ft.kernel_scalars(0.2, 0.5, 1.0, "cpu"), invm)
    before = dict(ft.grahmc_multistep_kernel.variant_launches)
    out = ft.grahmc_multistep_kernel(*args, key=key, call=1)
    assert ft.grahmc_multistep_kernel.variant_launches == before
    for a, b in zip(out, ft.grahmc_multistep_plain(*args, key=key, call=1)):
        assert torch.equal(a, b)
