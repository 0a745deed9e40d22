"""Registration from learned descriptors (3DSmoothNet/FCGF-style).

Equivalent of the 3DSmoothNet benchmark example
(/root/reference/examples/teaser_python_3dsmooth/teaser_python_3dsmooth.py +
bench_utils.py): load keypoints + precomputed learned descriptors, match by
mutual nearest neighbor in descriptor space, register, report errors vs a
ground-truth transform.

Inputs: two .npz files with arrays `points` (3, N) or (N, 3) and
`features` (N, D), plus an optional 4x4 ground-truth text file.

Usage:
    python examples/learned_descriptor_bench.py src.npz dst.npz [--gt GT.txt]
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

from psulvsb_tpu.core.metrics import angular_error_deg
from psulvsb_tpu.frontend.matcher import match_features
from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.api import register_pair


def load_npz(path):
    d = np.load(path)
    pts = d["points"]
    if pts.shape[0] != 3:
        pts = pts.T
    return pts.astype(np.float32), d["features"].astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("src_npz")
    ap.add_argument("dst_npz")
    ap.add_argument("--gt", default=None, help="4x4 ground-truth matrix file")
    ap.add_argument("--noise-bound", type=float, default=0.05)
    args = ap.parse_args()

    src_pts, src_f = load_npz(args.src_npz)
    dst_pts, dst_f = load_npz(args.dst_npz)
    corres = match_features(src_pts, dst_pts, src_f, dst_f,
                            use_crosscheck=True, use_tuple_test=False)
    print(f"{corres.shape[0]} mutual-NN descriptor matches")

    params = SolverParams.preset_artificial(
        noise_bound=args.noise_bound, noise_bound_dataset=args.noise_bound
    )
    sol, info = register_pair(
        jnp.asarray(src_pts[:, corres[:, 0]]),
        jnp.asarray(dst_pts[:, corres[:, 1]]),
        params,
        jax.random.PRNGKey(0),
    )
    print("rotation:\n", np.asarray(sol.rotation))
    print("translation:", np.asarray(sol.translation))
    print("inliers:", int(sol.final_inlier_count))
    if args.gt:
        gt = np.loadtxt(args.gt)
        print("rotation error (deg):",
              float(angular_error_deg(jnp.asarray(gt[:3, :3], jnp.float32), sol.rotation)))
        print("translation error:",
              float(np.linalg.norm(gt[:3, 3] - np.asarray(sol.translation))))


if __name__ == "__main__":
    main()
