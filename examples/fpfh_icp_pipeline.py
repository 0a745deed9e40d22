"""Raw-cloud pipeline: voxel -> normals -> FPFH -> match -> PSULVSB -> ICP.

Equivalent of the FPFH+ICP python example
(/root/reference/examples/teaser_python_fpfh_icp/example.py + helpers.py:
o3d voxel downsample, FPFH, mutual-NN matching, TEASER solve, o3d ICP
refinement) — all stages native here.

Usage: python examples/fpfh_icp_pipeline.py [src.ply dst.ply] [--voxel 0.05]
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

from psulvsb_tpu.core.metrics import angular_error_deg
from psulvsb_tpu.core.se3 import random_se3, transform_points
from psulvsb_tpu.eval.synthetic import synthetic_cloud
from psulvsb_tpu.frontend.voxel import voxel_downsample
from psulvsb_tpu.frontend.normals import estimate_normals
from psulvsb_tpu.frontend.fpfh import compute_fpfh
from psulvsb_tpu.frontend.matcher import match_features
from psulvsb_tpu.frontend.icp import icp_point_to_point
from psulvsb_tpu.io.ply import read_ply
from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.api import register_pair


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ply", nargs="*", help="src.ply dst.ply (synthetic if none)")
    ap.add_argument("--voxel", type=float, default=0.05)
    args = ap.parse_args()

    gt = None
    if len(args.ply) == 2:
        src_cloud = read_ply(args.ply[0])
        dst_cloud = read_ply(args.ply[1])
    else:
        # Default to the reference's shipped REAL indoor scan pair when
        # present (the same data its FPFH+ICP example registers); fall
        # back to a synthetic pair with a known ground truth.
        from psulvsb_tpu.eval.realscan import REALSCAN_PLYS, realscan_available

        if realscan_available():
            print(f"using reference scan pair: {REALSCAN_PLYS[0]}")
            src_cloud = read_ply(REALSCAN_PLYS[0])
            dst_cloud = read_ply(REALSCAN_PLYS[1])
        else:
            src_cloud = synthetic_cloud(800, seed=0)
            gt = random_se3(jax.random.PRNGKey(1), max_translation=1.0)
            dst_cloud = np.asarray(transform_points(gt, jnp.asarray(src_cloud)))

    def features(cloud):
        down = voxel_downsample(cloud, args.voxel)
        pts = jnp.asarray(down, jnp.float32)
        normals = estimate_normals(pts, k=20)
        return down, np.asarray(
            compute_fpfh(pts, normals, radius=5 * args.voxel, k=48)
        )

    src_d, src_f = features(src_cloud)
    dst_d, dst_f = features(dst_cloud)
    corres = match_features(src_d, dst_d, src_f, dst_f)
    print(f"{corres.shape[0]} correspondences")

    src_m = jnp.asarray(src_d[:, corres[:, 0]], jnp.float32)
    dst_m = jnp.asarray(dst_d[:, corres[:, 1]], jnp.float32)
    params = SolverParams.preset_artificial(noise_bound=args.voxel,
                                            noise_bound_dataset=args.voxel)
    sol, _ = register_pair(src_m, dst_m, params, jax.random.PRNGKey(0))
    print("coarse rotation:\n", np.asarray(sol.rotation))

    icp = icp_point_to_point(
        jnp.asarray(src_d, jnp.float32),
        jnp.asarray(dst_d, jnp.float32),
        init_rotation=sol.rotation,
        init_translation=sol.translation,
        max_correspondence_distance=2 * args.voxel,
    )
    print("refined rotation:\n", np.asarray(icp.rotation))
    print(f"ICP iterations: {int(icp.iterations)}, inlier RMSE: {float(icp.rmse):.5f}")
    if gt is not None:
        print(
            "rotation error (deg):",
            float(angular_error_deg(gt.rotation, icp.rotation)),
        )


if __name__ == "__main__":
    main()
