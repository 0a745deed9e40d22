"""Checks at deployment widths with every kernel compiled for the card.
Each calls the check function a chip_smoke.py phase calls; here they skip
without a GPU (see the `gpu` fixture in conftest.py)."""

import pytest

from psulvsb_tpu.eval import kernel_checks

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("scale", [1.0, 3.37])
@pytest.mark.parametrize("c", [5000, 16384])
def test_pair_grid_at_deployment_width(gpu, c, scale):
    kernel_checks.check_pair_grid(c, scale, init=True)


@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("n", [256, 2048])
def test_gnc_kernel_compiled(gpu, n, b):
    kernel_checks.check_gnc_kernel(n, b, seed=n + b)


def test_gnc_solve_kernel_matches_xla(gpu):
    """Full fused solves through the compiled kernel against the XLA loop."""
    kernel_checks.check_gnc_solve(1889, 256, 4, repeats=2)


def test_consistency_degree_at_frontend_width(gpu):
    src, dst, active = kernel_checks.pair_problem(6144, seed=1)
    kernel_checks.check_consistency_degree(src, dst, 0.6, active)
