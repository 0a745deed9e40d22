"""The published PSULVSB synthetic experiment protocol.

Equivalent of the PSULVSB driver main loop
(/root/reference/examples/teaser_cpp_ply/PSULVSB.cc:224-515): per cloud,
`trials` runs of {random SE(3) + noise + outliers -> normals -> histogram
pre-filter -> solve}, per-trial scale/rotation/translation/time/RMSE
errors, mean ± sigma aggregation to a per-cloud CSV and a global
Average.csv.
"""

from __future__ import annotations

import os
import zlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.core.metrics import angular_error_deg_np
from psulvsb_tpu.eval.pipeline import solve_with_prefilter
from psulvsb_tpu.eval.reporting import write_csv, mean_std
from psulvsb_tpu.eval.synthetic import make_synthetic_pair
from psulvsb_tpu.solver.config import SolverParams


class TrialResult(NamedTuple):
    scale_error: float
    angle_error_deg: float
    trans_error: float
    rmse: float
    time_s: float


def run_trial(
    key: jax.Array,
    src: jax.Array,
    params: SolverParams,
    noise_bound: float = 0.05,
    outlier_rate: float = 0.9,
) -> TrialResult:
    k_data, k_solve = jax.random.split(key)
    pair = make_synthetic_pair(
        k_data, src, noise_bound=noise_bound, outlier_rate=outlier_rate
    )
    res = solve_with_prefilter(pair.src, pair.dst, params, k_solve)
    sol = res.solution

    gt = pair.transform
    # Numpy scoring with one batched readback: a jnp op per trial result is
    # a device dispatch each.
    s_np, r_np, t_np, src_np, gt_r, gt_t, gt_s = jax.device_get(
        (sol.scale, sol.rotation, sol.translation, pair.src,
         gt.rotation, gt.translation, gt.scale)
    )
    s_f = float(s_np)
    r64 = np.asarray(r_np, np.float64)
    t64 = np.asarray(t_np, np.float64)
    src64 = np.asarray(src_np, np.float64)
    gt_r64 = np.asarray(gt_r, np.float64)
    gt_t64 = np.asarray(gt_t, np.float64)
    scale_err = abs(s_f - float(gt_s))
    angle_err = angular_error_deg_np(gt_r64, r64)
    trans_err = float(np.linalg.norm(t64 - gt_t64))
    # RMSE vs the noiseless ground-truth placement over ALL points
    # (PSULVSB.cc computes it against src_gt = T * src).
    gt_pts = gt_r64 @ src64 + gt_t64[:, None]
    est_pts = s_f * (r64 @ src64 + t64[:, None])
    rmse = float(np.sqrt(np.mean(np.sum((gt_pts - est_pts) ** 2, axis=0))))
    return TrialResult(scale_err, angle_err, trans_err, rmse, res.elapsed_s)


def run_protocol(
    clouds: dict[str, np.ndarray],
    params: SolverParams,
    out_dir: str,
    trials: int = 100,
    noise_bound: float = 0.05,
    outlier_rate: float = 0.9,
    seed: int = 0,
) -> dict[str, dict]:
    """clouds: {name: (3, N) array}. Writes <name>.csv per cloud and
    Average.csv; returns the aggregate stats dict."""
    os.makedirs(out_dir, exist_ok=True)
    aggregates = {}
    avg_rows = []
    for name, cloud in clouds.items():
        src = jnp.asarray(cloud, jnp.float32)
        rows = []
        results: list[TrialResult] = []
        name_tag = zlib.crc32(name.encode()) % (1 << 30)  # deterministic
        # Nested fold_in (by name, then trial) — additive name_tag + t would
        # alias trial streams of clouds whose tags differ by < trials.
        cloud_key = jax.random.fold_in(jax.random.PRNGKey(seed), name_tag)
        for t in range(trials):
            key = jax.random.fold_in(cloud_key, t)
            r = run_trial(key, src, params, noise_bound, outlier_rate)
            results.append(r)
            rows.append([t, r.scale_error, r.angle_error_deg, r.trans_error, r.rmse, r.time_s])
        write_csv(
            os.path.join(out_dir, f"{name}.csv"),
            ["trial", "ScaleError", "AngleError", "TransError", "RMSE", "Time"],
            rows,
        )
        stats = {}
        for field in TrialResult._fields:
            vals = [getattr(r, field) for r in results]
            stats[field] = mean_std(vals)
        aggregates[name] = stats
        avg_rows.append(
            [name]
            + [x for field in TrialResult._fields for x in stats[field]]
        )
    write_csv(
        os.path.join(out_dir, "Average.csv"),
        ["cloud"]
        + [
            f"{field}_{suffix}"
            for field in TrialResult._fields
            for suffix in ("mean", "std")
        ],
        avg_rows,
    )
    return aggregates
