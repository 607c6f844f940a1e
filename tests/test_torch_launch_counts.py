"""Launch counts by shape and the kernels line's rows, on the CPU.

Each wrapper counts a launch where it launches its kernel, in total, per
variant and per (variant, family, n_chains, dim)
(ops/fused_trajectory.py:count_launch; the wrappers call it only on CUDA
tensors, so these tests call it directly). chip_smoke.py reads the counts
of every main path (launch_counts, shape_counts) and gives each row of its
kernels line the launches measured at that row's shape (row_launches): a
split row its path's launches at its chains, the family sweep's and the
[5o] cells' launches their "kernel (family)" pairs, every other launch its
kernel's own row."""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402
from mcmc_tpu_torch.ops import fused_nuts as fn  # noqa: E402
from mcmc_tpu_torch.ops import fused_rwmh as fr  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402

FUNNEL = {"family": "neals_funnel"}
HIER = {"family": "hierarchical_logistic"}


@pytest.fixture
def zeroed():
    for module in (ft, fr, fn):
        module.reset_launches()
    yield
    for module in (ft, fr, fn):
        module.reset_launches()


def test_count_launch_keys_each_launch_by_its_shape(zeroed):
    kernel = ft.grahmc_step_kernel
    ft.count_launch(kernel, "dense", FUNNEL, torch.zeros(7, 5))
    ft.count_launch(kernel, "dense", FUNNEL, torch.zeros(7, 5))
    ft.count_launch(kernel, "diagonal", FUNNEL, torch.zeros(9, 5))
    ft.count_launch(kernel, "diagonal+data", HIER, torch.zeros(9, 3))
    assert kernel.launches == 4
    assert kernel.variant_launches == {"diagonal": 1, "dense": 2, "diagonal+data": 1,
                                       "dense+data": 0}
    assert kernel.shape_launches == {("dense", "neals_funnel", 7, 5): 2,
                                     ("diagonal", "neals_funnel", 9, 5): 1,
                                     ("diagonal+data", "hierarchical_logistic", 9, 3): 1}
    ft.reset_launches()
    assert kernel.launches == 0 and kernel.shape_launches == {}
    assert set(kernel.variant_launches.values()) == {0}


@pytest.mark.parametrize("module", [ft, fr, fn])
def test_reset_zeroes_the_counts_by_shape(module, zeroed):
    kernels = ft.KERNELS if module is ft else (
        [fr.rwmh_multistep_kernel] if module is fr else [fn.nuts_window_kernel])
    for kernel in kernels:
        name = next(iter(kernel.variant_launches))
        ft.count_launch(kernel, name, FUNNEL, torch.zeros(4, 2))
        assert kernel.shape_launches == {(name, "neals_funnel", 4, 2): 1}
    module.reset_launches()
    assert all(k.shape_launches == {} and k.launches == 0 for k in kernels)


def test_chip_smoke_reads_every_kernel_variant_by_shape(zeroed):
    ft.count_launch(ft.grahmc_step_kernel, "dense", FUNNEL, torch.zeros(7, 5))
    ft.count_launch(ft.grahmc_multistep_kernel, "diagonal+data", HIER, torch.zeros(3, 9))
    ft.count_launch(fr.rwmh_multistep_kernel, "rwmh+data", HIER, torch.zeros(3, 9))
    ft.count_launch(fn.nuts_window_kernel, "multinomial+dense", FUNNEL, torch.zeros(2, 5))
    ft.count_launch(fn.nuts_window_kernel, "multinomial+dense", FUNNEL, torch.zeros(2, 5))
    shapes = cs.shape_counts(ft, fr, fn)
    assert shapes == {("grahmc_step_kernel[dense]", "neals_funnel", 7, 5): 1,
                      ("grahmc_multistep_kernel[data]", "hierarchical_logistic", 3, 9): 1,
                      ("rwmh_multistep_kernel[data]", "hierarchical_logistic", 3, 9): 1,
                      ("nuts_window_kernel[multinomial+dense]", "neals_funnel", 2, 5): 2}
    totals = cs.launch_counts(ft, fr, fn)
    assert {k: n for k, n in totals.items() if n} == {
        "grahmc_step_kernel[dense]": 1, "grahmc_multistep_kernel[data]": 1,
        "rwmh_multistep_kernel[data]": 1, "nuts_window_kernel[multinomial+dense]": 2}
    assert all(sum(n for key, n in shapes.items() if key[0] == name) == total
               for name, total in totals.items())


DENSE_ROW = "dense-warmup GRAHMC row"
PATHS = {
    "GRAHMC main path": {("grahmc_step_kernel", "neals_funnel", cs.CHAINS, cs.DIM): 10},
    DENSE_ROW: {("grahmc_step_kernel[dense]", "correlated_gaussian", cs.CHAINS, cs.DIM): 7,
                ("grahmc_step_kernel[dense]", "correlated_gaussian", cs.MULTI_CHAINS,
                 cs.DIM): 3,
                ("grahmc_step_kernel", "correlated_gaussian", cs.MULTI_CHAINS, cs.DIM): 4,
                ("grahmc_multistep_kernel", "correlated_gaussian", cs.MULTI_CHAINS,
                 cs.DIM): 2},
    "ChEES row": {("grahmc_step_kernel", "neals_funnel_noncentered", 4096, 20): 5},
    "family sweep": {("grahmc_step_kernel", "student_t", 1024, 10): 6,
                     ("grahmc_step_kernel", "log_gamma", 1024, 10): 5,
                     ("nuts_window_kernel", "student_t", 1024, 10): 8},
    "rosenbrock10 cell": {("grahmc_step_kernel[dense]", "rosenbrock", 1024, 10): 2},
    "rosenbrock20 cell": {("grahmc_step_kernel[dense]", "rosenbrock", 1024, 20): 1},
}


@pytest.mark.parametrize("row,launches,shapes", [
    ("grahmc_step_kernel", 10, {(cs.CHAINS, cs.DIM, "neals_funnel"): 10}),
    ("grahmc_step_kernel[dense]", 7, {(cs.CHAINS, cs.DIM, "correlated_gaussian"): 7}),
    ("grahmc_step_kernel[dense] (4,096 chains)", 3,
     {(cs.MULTI_CHAINS, cs.DIM, "correlated_gaussian"): 3}),
    ("grahmc_step_kernel (4,096 chains)", 4,
     {(cs.MULTI_CHAINS, cs.DIM, "correlated_gaussian"): 4}),
    ("grahmc_step_kernel (ChEES row)", 5, {(4096, 20, "neals_funnel_noncentered"): 5}),
    ("grahmc_multistep_kernel", 2, {(cs.MULTI_CHAINS, cs.DIM, "correlated_gaussian"): 2}),
])
def test_each_row_takes_the_launches_of_its_shape(row, launches, shapes):
    own, _pairs, at_shape = cs.row_launches(PATHS)
    assert own[row] == launches
    assert at_shape[row] == shapes


def test_the_sweep_and_cells_give_pairs_by_family():
    own, pairs, at_shape = cs.row_launches(PATHS)
    assert pairs == {"grahmc_step_kernel (student_t)": 6, "grahmc_step_kernel (log_gamma)": 5,
                     "nuts_window_kernel (student_t)": 8,
                     "grahmc_step_kernel[dense] (rosenbrock)": 3}
    assert at_shape["grahmc_step_kernel[dense] (rosenbrock)"] == {
        (1024, 10, "rosenbrock"): 2, (1024, 20, "rosenbrock"): 1}
    # every launch lands in exactly one row
    assert sum(own.values()) + sum(pairs.values()) == sum(
        n for counts in PATHS.values() for n in counts.values())


def test_a_split_row_takes_only_its_own_chains():
    """The dense-warmup row's launches at another chain count stay on the
    kernel's own row, and a split row is absent when nothing ran there."""
    paths = {DENSE_ROW: {("grahmc_step_kernel", "correlated_gaussian", 2048, cs.DIM): 4}}
    own, pairs, _ = cs.row_launches(paths)
    assert own == {"grahmc_step_kernel": 4} and pairs == {}


def test_the_tune_clis_warmups_take_the_4096_chain_row():
    """[5s]'s kernel-1 launches at 4,096 chains (the GRAHMC grid's warmups
    and gamma tunes on the funnel) join the dense-warmup row's in the
    4,096-chain row; its kernel-2 and kernel-3 launches stay on their
    kernels' own rows."""
    paths = dict(PATHS)
    paths[cs.TUNE_CLI_PATH] = {
        ("grahmc_step_kernel", "neals_funnel", cs.MULTI_CHAINS, cs.DIM): 6,
        ("grahmc_multistep_kernel", "neals_funnel", cs.MULTI_CHAINS, cs.DIM): 3,
        ("rwmh_multistep_kernel", "standard_normal", cs.TUNE_CLI_RWMH_CHAINS, cs.RWMH_DIM): 2}
    own, _pairs, at_shape = cs.row_launches(paths)
    assert own["grahmc_step_kernel (4,096 chains)"] == 4 + 6
    assert at_shape["grahmc_step_kernel (4,096 chains)"] == {
        (cs.MULTI_CHAINS, cs.DIM, "correlated_gaussian"): 4,
        (cs.MULTI_CHAINS, cs.DIM, "neals_funnel"): 6}
    assert own["grahmc_step_kernel"] == 10 and own["grahmc_multistep_kernel"] == 2 + 3
    assert own["rwmh_multistep_kernel"] == 2
    assert "grahmc_step_kernel[dense] (4,096 chains)" in own and own[
        "grahmc_step_kernel[dense] (4,096 chains)"] == 3


def test_tune_cli_expected_launches_follow_its_arguments():
    """[5s]'s flags and its launch arithmetic share their constants: T 8 at
    4,096 chains for kernel 2, T 32 at its RWMH batch for kernel 3."""
    args = dict(zip(cs.TUNE_CLI_GRID_ARGS[::2], cs.TUNE_CLI_GRID_ARGS[1::2]))
    assert int(args["--chains"]) == cs.MULTI_CHAINS and int(args["--dim"]) == cs.DIM
    assert int(args["--batch-size"]) % cs.MULTI_T == 0
    assert int(args["--max-samples"]) == cs.TUNE_CLI_DRAWS
    assert args["--num-steps-grid"] == ",".join(map(str, cs.TUNE_CLI_GRID))
    rwmh = dict(zip(cs.TUNE_CLI_RWMH_ARGS[::2], cs.TUNE_CLI_RWMH_ARGS[1::2]))
    assert int(rwmh["--batch-size"]) % cs.RWMH_T == 0
    assert int(rwmh["--max-samples"]) == cs.TUNE_CLI_RWMH_DRAWS
