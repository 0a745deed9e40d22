"""Full per-pair registration pipeline: normals -> normal-angle histogram
pre-filter -> PSULVSB solve.

This is the sequence both reference drivers run per pair
(PSULVSB.cc:303-328, teaser_cpp_ply_main.cc:330-422): PCL normals (k = 20),
histogram_outlier_removal producing keep_mask/reduce_map, then
RobustRegistrationSolver::solve on the reduced set with ori_* in Params.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.utils.padding import (
    DEFAULT_PAD_BUCKETS,
    pad_columns,
    pad_to_bucket,
)
from psulvsb_tpu.frontend.normals import estimate_normals
from psulvsb_tpu.frontend.histogram_filter import normal_angle_histogram_filter
from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.solver.psulvsb import psulvsb_solve
from psulvsb_tpu.solver.fused import psulvsb_register
from psulvsb_tpu.solver.solution import RegistrationSolution


class PipelineResult(NamedTuple):
    solution: RegistrationSolution
    keep_mask: jax.Array
    elapsed_s: float


def pad_bucket(c: int, pad_buckets: tuple[int, ...] = DEFAULT_PAD_BUCKETS) -> int:
    """Padded size bucket a C-correspondence pair compiles under. Beyond the
    largest bucket this grows (1024-aligned) rather than truncate — see
    utils/padding.pad_to_bucket."""
    return pad_to_bucket(c, pad_buckets)


def solve_with_prefilter(
    src,
    dst,
    params: SolverParams,
    key: jax.Array,
    normal_k: int = 20,
    fused: bool = True,
    pad_buckets: tuple[int, ...] = DEFAULT_PAD_BUCKETS,
    use_prefilter: bool = True,
) -> PipelineResult:
    """src/dst: (3, C) matched correspondence matrices (original set).

    Inputs are padded to a size bucket (keep_mask = -2 on padding, which
    never votes anywhere in the solver) so a dataset sweep with varying
    correspondence counts reuses a handful of compiled programs instead of
    recompiling per pair.

    use_prefilter: the normal-angle histogram filter permanently discards
    (-1) bins far from the peak (PSULVSB.cc:156-168 — reference parity).
    Because an inlier's src/dst normal angle acos(n . R n) spreads with the
    rotation magnitude, large-rotation pairs can lose true inliers to the
    -1 bucket with no self-update recourse; pass False to feed the solver
    the full correspondence set instead.
    """
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    c = src.shape[1]
    target = pad_bucket(c, pad_buckets)
    src_p = jnp.asarray(pad_columns(src, target))
    dst_p = jnp.asarray(pad_columns(dst, target))
    valid = jnp.arange(target) < c
    t0 = time.monotonic()

    if use_prefilter:
        src_normals = estimate_normals(src_p, k=normal_k, active=valid)
        dst_normals = estimate_normals(dst_p, k=normal_k, active=valid)
        keep_mask, _ = normal_angle_histogram_filter(
            src_normals, dst_normals, active=valid
        )
        keep_mask = jnp.where(valid, keep_mask, -2)
    else:
        keep_mask = jnp.where(valid, 1, -2).astype(jnp.int32)

    if fused:
        sol = jax.block_until_ready(
            psulvsb_register(src_p, dst_p, keep_mask, key, params)
        )
    else:
        sol, _info = psulvsb_solve(src_p, dst_p, keep_mask, params, key)
    return PipelineResult(
        solution=sol, keep_mask=keep_mask, elapsed_s=time.monotonic() - t0
    )
