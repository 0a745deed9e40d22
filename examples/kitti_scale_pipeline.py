"""KITTI-scale raw-cloud pipeline: 100k points end-to-end on one card.

The BASELINE.md eval configs include "KITTI odometry pairs (~100k pts)".
This driver exercises the full raw-cloud path at that size — voxel-grid
downsample -> normals -> ISS keypoints -> FPFH-33 -> NN matching
(eval/corr_gen.py, the teaser_cpp_ply.cc:179-329 equivalent) -> fused
PSULVSB solve — on a synthetic outdoor-scale pair with a known SE(3).

By default the fixture is `structured_scene` — ground plane + box
buildings + poles, i.e. the planar/corner structure FPFH keys on — and the
driver reports the front-end MATCH INLIER RATE (fraction of produced
correspondences within the noise bound of the GT mapping), the front-end
quality number. `--blobby` switches back to the old spherical-harmonics
cloud, a hostile fixture for FPFH (no planar structure) whose match
quality only lower-bounds real scans.

Usage:
    python examples/kitti_scale_pipeline.py [n_points] [--blobby]
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

from psulvsb_tpu.eval.corr_gen import generate_correspondences
from psulvsb_tpu.eval.synthetic import synthetic_cloud
from psulvsb_tpu.core.se3 import random_se3
from psulvsb_tpu.core.metrics import angular_error_deg
from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.solver.fused import psulvsb_register


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    n_pts = int(args[0]) if args else 100_000
    blobby = "--blobby" in sys.argv
    rng = np.random.default_rng(0)

    if blobby:
        base = np.asarray(synthetic_cloud(n_pts, seed=3)) * 20.0  # 40 m scene
    else:
        from psulvsb_tpu.eval.synthetic import structured_scene

        base = np.asarray(structured_scene(n_pts, seed=3, extent=40.0))
    t = random_se3(jax.random.PRNGKey(2), max_translation=10.0)
    rot = np.asarray(t.rotation)
    trans = np.asarray(t.translation)
    dst_cloud = rot @ base + trans[:, None] + rng.normal(size=base.shape) * 0.02

    t0 = time.perf_counter()
    src_kp, dst_m = generate_correspondences(base, dst_cloud, noise_bound=0.3)
    t_gen = time.perf_counter() - t0
    c = src_kp.shape[1]
    # Front-end quality: a produced correspondence is a true match when the
    # GT-transformed source keypoint lands within the noise bound of its
    # matched target point.
    resid = np.linalg.norm(
        rot @ np.asarray(src_kp) + trans[:, None] - np.asarray(dst_m), axis=0
    )
    inlier_rate = float(np.mean(resid < 0.3))
    print(
        f"n_pts={n_pts}: corr_gen {t_gen:.1f} s -> {c} correspondences, "
        f"match inlier rate {inlier_rate:.2f}"
    )
    if c < 50:
        raise SystemExit("too few keypoint correspondences")

    # The solver's noise bound must cover the correspondence error scale:
    # keypoints come from two INDEPENDENT voxel grids at leaf 0.3, so even
    # true matches carry up to ~half-leaf quantization offsets per cloud on
    # top of sensor noise (preset_kitti's 0.1 undershoots that). Scale is
    # known (odometry is rigid): under estimate_scaling the structured
    # scene's correlated wall-to-wall mismatches can collapse the scale TLS
    # to zero consensus — the reference's real-data driver likewise runs
    # known-scale unless unknownScale is requested.
    params = SolverParams.preset_kitti(
        noise_bound=0.3, noise_bound_dataset=0.3, estimate_scaling=False,
        sampled_cap=4096, basic_cap=1024, hypothesis_batch=16,
    )
    keep = jnp.ones((c,), jnp.int32)
    src_j = jnp.asarray(src_kp, jnp.float32)
    dst_j = jnp.asarray(dst_m, jnp.float32)
    s = psulvsb_register(src_j, dst_j, keep, jax.random.PRNGKey(0), params)
    _ = float(s.scale)  # compile + sync
    t0 = time.perf_counter()
    s = psulvsb_register(src_j, dst_j, keep, jax.random.PRNGKey(1), params)
    _ = float(s.translation[0])
    t_solve = time.perf_counter() - t0
    re = float(angular_error_deg(t.rotation, s.rotation))
    te = float(np.linalg.norm(np.asarray(s.translation) - trans))
    print(f"solve {t_solve * 1e3:.0f} ms  rot_err {re:.3f} deg  trans_err {te:.3f} m")


if __name__ == "__main__":
    main()
