"""Exact pair-grid reductions (ops/pair_grid.py) and the init-mode choice
against float64 numpy, through the same checks the card runs at
deployment widths (eval/kernel_checks.py)."""

import jax.numpy as jnp
import pytest

from psulvsb_tpu.eval.kernel_checks import check_pair_grid
from psulvsb_tpu.pairs.tims import sort_peak_bin
from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.solver.psulvsb import resolve_init_mode

BLOCK = 128


@pytest.mark.parametrize("scale", [1.0, 3.37])
@pytest.mark.parametrize("active_frac", [1.0, 0.7])
@pytest.mark.parametrize("c", [2 * BLOCK, 2 * BLOCK + 45])
def test_histogram_and_beta_count_match_float64(c, active_frac, scale):
    """Row tiles that divide C and tiles that leave a padded remainder,
    with and without inactive points, at known and unknown scale; the
    dense init takes the same grid."""
    out = check_pair_grid(
        c, scale, active_frac=active_frac, seed=c, block=BLOCK, init=True
    )
    assert out["init_known_scale_mode"] == "dense"


@pytest.mark.parametrize("scale", [1.0, 3.37])
def test_row_blocked_init_matches_float64(scale):
    """C beyond dense_init_max_c takes the row-blocked exact_hist /
    exact_beta init; its |reduced| matches the float64 sweep."""
    out = check_pair_grid(
        300, scale, seed=7, block=BLOCK, init=True, dense_init_max_c=256
    )
    assert out["init_unknown_scale_mode"] == "exact_hist"
    assert out["init_known_scale_mode"] == "exact_beta"


@pytest.mark.parametrize(
    "bins, active",
    [
        ([5, 5, 9, 9, 2], [1, 1, 1, 1, 1]),  # two-way tie: lower bin wins
        ([7, 3, 7, 3, 1, 1], [1, 1, 1, 1, 1, 1]),  # three-way tie
        ([4, 4, 8, 8, 8], [1, 1, 0, 1, 1]),  # inactive entries break a tie
    ],
)
def test_histogram_argmax_breaks_ties_like_sort_peak(bins, active):
    """The exact histogram's peak (first argmax of the counts, as the
    init stages take it) equals pairs/tims.sort_peak_bin on ties."""
    num_bins = 16
    idx = jnp.asarray(bins, jnp.int32)
    act = jnp.asarray(active, bool)
    counts = jnp.zeros((num_bins,), jnp.int32).at[idx].add(act.astype(jnp.int32))
    want, _ = sort_peak_bin(idx, act, num_bins)
    assert int(jnp.argmax(counts)) == int(want)


@pytest.mark.parametrize(
    "c, estimate_scaling, mode",
    [
        (100, False, "dense"),
        (8192, True, "dense"),
        (8193, True, "exact_hist"),
        (8193, False, "exact_beta"),
    ],
)
def test_init_mode_chosen_by_c_alone(c, estimate_scaling, mode):
    params = SolverParams(estimate_scaling=estimate_scaling)
    assert resolve_init_mode(params, c) == mode


def test_full_range_peak_beyond_old_window():
    """A scale ratio of 200 (bin 4000) is found by the full-range
    histogram: no window or certificate limits the peak."""
    out = check_pair_grid(200, 200.0, seed=3, block=BLOCK)
    assert out["peak"] == out["ref_peak"]
    assert abs(out["peak"] / 20.0 - 200.0) < 1.0
