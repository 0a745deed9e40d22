"""End-to-end front-end protocol: raw clouds -> voxel/ISS/FPFH/NN ->
reference-format correspondence files -> batched harness.

The reference generates its solver inputs from raw scans (voxel-grid
downsample -> ISS keypoints -> FPFH -> nearest-neighbor matching,
/root/reference/TEASER-plusplus/examples/teaser_cpp_ply/
teaser_cpp_ply.cc:179-329). The five generated protocols in bench.py feed
the solver synthetic mismatch outliers instead — uniform permutations whose
wrong matches never collude. This module closes that gap: every correspondence the solver sees here was produced by the
real descriptor front-end on partially-overlapping structured scenes, so
wrong matches carry the spatial clustering and repeated-geometry structure
real FPFH produces, and non-overlap keypoints contribute genuinely
unmatched outliers.

Static-shape discipline: the per-pair front-end runs at ONE padded
cloud bucket (FRONT_BUCKET) with active masks through every kernel
(normals/ISS/FPFH/kNN all take `active`), so the whole >=100-pair
generation reuses a single compiled program per stage instead of paying a
per-pair compile for each voxel-downsampled cardinality.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.core.se3 import random_se3
from psulvsb_tpu.eval.synthetic import structured_scene
from psulvsb_tpu.frontend.fpfh import compute_fpfh
from psulvsb_tpu.frontend.iss import iss_keypoints
from psulvsb_tpu.frontend.knn import knn
from psulvsb_tpu.frontend.normals import estimate_normals
from psulvsb_tpu.frontend.voxel import voxel_downsample
from psulvsb_tpu.utils.padding import pad_columns

# Conventions measured in tests/test_structured_scene.py: voxel leaf =
# noise bound 0.3 on extent-40 structured scenes gives FPFH real signal
# (inlier rate ~0.2 within the overlap).
NOISE_BOUND = 0.3
FRONT_BUCKET = 8192
SCENE_POINTS = 24000
EXTENT = 40.0


def _extract_padded(cloud: np.ndarray, bucket: int = FRONT_BUCKET,
                    keypoints: str = "all"):
    """voxel -> normals -> [ISS] -> FPFH at a fixed padded shape.

    Returns (points (3, bucket) f32, match mask (bucket,) bool, features
    (bucket, 33) f32). keypoints="iss" restricts the match mask to ISS
    keypoints (teaser_cpp_ply.cc:189-204's generator); "all" matches every
    downsampled point — the regime of the reference's 3DMatch FPFH
    benchmark files (~5k dense-feature correspondences per pair), and the
    one that survives partial overlap: ISS maxima are not repeatable across
    independently-voxelized views (measured ~15% oracle repeatability),
    while voxel representatives always have an overlap counterpart within
    a leaf. Downsampled clouds larger than the bucket are evenly strided
    down (never truncated to a prefix, which would crop the scene
    spatially)."""
    down = np.asarray(voxel_downsample(np.asarray(cloud), NOISE_BOUND))
    m = down.shape[1]
    if m > bucket:
        down = down[:, np.linspace(0, m - 1, bucket).astype(int)]
        m = bucket
    pts = jnp.asarray(pad_columns(down.astype(np.float32), bucket))
    active = jnp.arange(bucket) < m
    normals = estimate_normals(pts, k=20, active=active)
    if keypoints == "iss":
        kp = iss_keypoints(
            pts,
            salient_radius=6.0 * NOISE_BOUND,
            non_max_radius=4.0 * NOISE_BOUND,
            k=64,
            active=active,
        ) & active
    else:
        kp = active
    feats = compute_fpfh(
        pts, normals, radius=5.0 * NOISE_BOUND, k=64, active=active
    )
    return pts, kp, feats


def make_frontend_pair(
    seed: int,
    n_points: int = SCENE_POINTS,
    overlap_keep: float = 0.65,
    max_corr: int = 6144,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One raw-scan-style pair through the full front-end.

    Scene -> two partial views (each keeps `overlap_keep` of the scene along
    a random direction from opposite ends, overlapping in the middle) ->
    independent sensor jitter -> dst rigidly moved by a random SE(3) ->
    voxel/ISS/FPFH/NN matching. Returns ((3, C) src keypoints, (3, C)
    matched dst points, (4, 4) GT matrix); C varies with what the detector
    found (that IS the protocol — real cardinality spread exercises the
    harness pad buckets)."""
    rng = np.random.default_rng(seed)
    scene = np.asarray(structured_scene(n_points, seed=seed, extent=EXTENT),
                       np.float64)
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    proj = d @ scene
    qa = np.quantile(proj, overlap_keep)
    qb = np.quantile(proj, 1.0 - overlap_keep)
    view_a = scene[:, proj <= qa]
    view_b = scene[:, proj >= qb]

    gt_se3 = random_se3(
        jax.random.PRNGKey(seed), max_translation=10.0, dtype=jnp.float32
    )
    rot = np.asarray(gt_se3.rotation, np.float64)
    trans = np.asarray(gt_se3.translation, np.float64)
    src_cloud = view_a + rng.normal(size=view_a.shape) * 0.02
    dst_cloud = (
        rot @ view_b + trans[:, None] + rng.normal(size=view_b.shape) * 0.02
    )

    sp, skp, sf = _extract_padded(src_cloud)
    dp, dkp, df = _extract_padded(dst_cloud)
    # Mutual nearest neighbor in feature space at static padded shapes
    # (matcher.cc:184-218's cross-check, re-posed with active masks so ONE
    # compiled kNN program serves every pair). Queries span all bucket
    # rows; inactive/non-keypoint queries are masked after readback.
    nn_sd, _ = knn(sf.T, df.T, k=1, point_active=dkp)
    nn_ds, _ = knn(df.T, sf.T, k=1, point_active=skp)
    nn_sd = np.asarray(nn_sd[:, 0])
    nn_ds = np.asarray(nn_ds[:, 0])
    skp_np = np.asarray(skp)
    src_idx = np.where(skp_np & (nn_ds[nn_sd] == np.arange(nn_sd.size)))[0]
    if src_idx.size > max_corr:
        src_idx = src_idx[np.linspace(0, src_idx.size - 1, max_corr).astype(int)]
    sp_np = np.asarray(sp, np.float64)
    dp_np = np.asarray(dp, np.float64)
    src_kp = sp_np[:, src_idx]
    dst_m = dp_np[:, nn_sd[src_idx]]

    gt = np.eye(4)
    gt[:3, :3] = rot
    gt[:3, 3] = trans
    return src_kp, dst_m, gt


def write_frontend_benchmark(
    data_root: str,
    scenes: list[str],
    n_pairs: int = 60,
    seed: int = 0,
) -> None:
    """Write a reference-format benchmark tree whose correspondences come
    from the real front-end (pairs.txt + @corr.txt + @GTmat.txt + gt.log,
    the exact layout eval/realdata.py reads)."""
    for si, scene in enumerate(scenes):
        scene_dir = os.path.join(data_root, scene)
        os.makedirs(scene_dir, exist_ok=True)
        labels = []
        gt_log_blocks = []
        for i in range(n_pairs):
            a, b = i, i + 1
            src, dst, gt = make_frontend_pair(seed + 9173 * si + 31 * i)
            stem = os.path.join(scene_dir, f"cloud_bin_{a}+cloud_bin_{b}")
            np.savetxt(
                stem + "@corr.txt", np.concatenate([src, dst]).T, fmt="%.8f"
            )
            np.savetxt(stem + "@GTmat.txt", gt, fmt="%.10f")
            labels.append((a, b))
            gt_log_blocks.append(
                f"{a} {b} {n_pairs + 1}\n"
                + "\n".join(
                    " ".join(f"{v:.10f}" for v in row) for row in gt
                )
            )
        with open(os.path.join(scene_dir, "pairs.txt"), "w") as f:
            f.write("\n".join(f"{a} {b}" for a, b in labels) + "\n")
        with open(os.path.join(scene_dir, "gt.log"), "w") as f:
            f.write("\n".join(gt_log_blocks) + "\n")


def frontend_solver_params(**overrides):
    """Solver params matching the front-end's noise regime: the voxel leaf
    quantizes keypoints by up to ~leaf/2 per axis, so the solver bound is
    the front-end NOISE_BOUND (0.3), not preset_kitti's raw-scan 0.1
    (tests/test_structured_scene.py measured the mis-parameterization).

    gror_init + translation_rescue: the descriptor regime's two measured
    failure modes at ~1% inlier rate (docs/FRONTEND_FAILURES.md) — GNC
    plateaus that only GROR's edge-hypothesis search escapes, and
    repeated-geometry translation aliasing that the gated global re-stab
    corrects (3/120 failing pairs -> 0 with both on)."""
    from psulvsb_tpu.solver.config import SolverParams

    return SolverParams.preset_kitti(
        **{
            "noise_bound": NOISE_BOUND,
            "noise_bound_dataset": NOISE_BOUND,
            "gror_init": True,
            "translation_rescue": True,
            **overrides,
        }
    )
