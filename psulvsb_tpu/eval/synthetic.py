"""Synthetic experiment protocol — the published PSULVSB driver's data
generator (/root/reference/examples/teaser_cpp_ply/PSULVSB.cc):

- random SE(3): uniform axis, angle in [0, pi), ||t|| <= 3 (PSULVSB.cc:256-278)
- per-coordinate uniform noise in [-noise_bound, +noise_bound]
  (addNoiseAndOutliers, PSULVSB.cc:190-194: Eigen ::Random * NOISE_BOUND)
- outliers: a fraction of target points displaced per-axis by a uniform
  draw from ±[5, 10] (PSULVSB.cc:196-221)

The reference loads the Stanford bunny PLY; here a deterministic synthetic
surface cloud stands in (any cloud works — the protocol only needs points).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.core.se3 import SE3, random_se3, transform_points


def synthetic_cloud(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Deterministic blobby closed surface: unit sphere modulated by a few
    random spherical harmonics — bunny-scale geometry (coords ~ ±1) with
    non-trivial normals. Returns (3, n)."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(1 - 2 * rng.uniform(size=n))
    phi = rng.uniform(0, 2 * np.pi, size=n)
    r = 1.0
    for k in range(3, 7):
        a = rng.normal() * 0.08
        b = rng.normal() * 0.08
        r = r + a * np.cos(k * theta) + b * np.sin(k * phi) * np.sin(theta)
    pts = np.stack(
        [
            r * np.sin(theta) * np.cos(phi),
            r * np.sin(theta) * np.sin(phi),
            r * np.cos(theta),
        ]
    )
    return pts.astype(dtype)


def structured_scene(
    n: int, seed: int = 0, extent: float = 40.0, dtype=np.float32
) -> np.ndarray:
    """Urban-style structured scene: ground plane, box buildings, and
    vertical poles — the planar/corner/edge structure FPFH keys on (the
    blobby `synthetic_cloud` has none at outdoor scale, which is why the
    KITTI-scale example's match quality on it only lower-bounds real
    scans). Point density is surface-area weighted; every surface carries
    mild jitter so normals are estimable but not degenerate. Returns
    (3, n), coordinates spanning roughly ±extent/2 in x/y."""
    rng = np.random.default_rng(seed)
    half = extent / 2.0
    chunks: list[np.ndarray] = []

    def sample_rect(origin, u, v, m):
        """m points on the parallelogram origin + a*u + b*v, a,b ~ U[0,1]."""
        a = rng.uniform(size=m)[:, None]
        b = rng.uniform(size=m)[:, None]
        return (np.asarray(origin)[None, :] + a * np.asarray(u)[None, :]
                + b * np.asarray(v)[None, :])

    # Ground plane: 30% of points.
    n_ground = int(n * 0.30)
    chunks.append(sample_rect(
        (-half, -half, 0.0), (extent, 0, 0), (0, extent, 0), n_ground
    ))

    # Buildings: 60% of points over ~8 boxes; walls + roof sampled
    # area-weighted, so corners and wall/roof edges appear at natural
    # density.
    n_build = int(n * 0.60)
    boxes = []
    for _ in range(8):
        w, d = rng.uniform(4.0, 10.0, size=2)
        h = rng.uniform(5.0, 15.0)
        x0 = rng.uniform(-half + 2, half - 12)
        y0 = rng.uniform(-half + 2, half - 12)
        boxes.append((x0, y0, w, d, h))
    areas = np.array([2 * (w + d) * h + w * d for (_, _, w, d, h) in boxes])
    per_box = (areas / areas.sum() * n_build).astype(int)
    for (x0, y0, w, d, h), m in zip(boxes, per_box):
        faces = [
            ((x0, y0, 0), (w, 0, 0), (0, 0, h), w * h),          # south wall
            ((x0, y0 + d, 0), (w, 0, 0), (0, 0, h), w * h),      # north wall
            ((x0, y0, 0), (0, d, 0), (0, 0, h), d * h),          # west wall
            ((x0 + w, y0, 0), (0, d, 0), (0, 0, h), d * h),      # east wall
            ((x0, y0, h), (w, 0, 0), (0, d, 0), w * d),          # roof
        ]
        fa = np.array([f[3] for f in faces])
        per_face = rng.multinomial(m, fa / fa.sum())
        for (origin, u, v, _a), fm in zip(faces, per_face):
            if fm:
                chunks.append(sample_rect(origin, u, v, fm))

    # Poles: the remainder, as thin vertical cylinders (edge-like features).
    n_pole = n - sum(c.shape[0] for c in chunks)
    if n_pole > 0:
        k = max(n_pole // 200, 4)
        centers = rng.uniform(-half + 1, half - 1, size=(k, 2))
        which = rng.integers(0, k, size=n_pole)
        ang = rng.uniform(0, 2 * np.pi, size=n_pole)
        z = rng.uniform(0, 6.0, size=n_pole)
        r = 0.15
        chunks.append(np.stack([
            centers[which, 0] + r * np.cos(ang),
            centers[which, 1] + r * np.sin(ang),
            z,
        ], axis=1))

    pts = np.concatenate(chunks, axis=0)[:n]
    pts = pts + rng.normal(size=pts.shape) * 0.01  # sensor-like jitter
    return np.ascontiguousarray(pts.T.astype(dtype))


class SyntheticPair(NamedTuple):
    src: jax.Array  # (3, N)
    dst: jax.Array  # (3, N)
    transform: SE3  # ground truth
    outlier_mask: jax.Array  # (N,) bool — True where dst was corrupted


def make_synthetic_pair(
    key: jax.Array,
    src: jax.Array,
    noise_bound: float = 0.05,
    outlier_rate: float = 0.9,
    max_translation: float = 3.0,
    outlier_mode: str = "displace",
) -> SyntheticPair:
    """dst = T(src) + uniform noise, then `outlier_rate` of the points are
    corrupted.

    outlier_mode:
      "displace" — large per-axis displacement with magnitude uniform in
        [5, 10] and random sign (PSULVSB.cc:196-221, the published
        protocol). Displaced points float in space, so normals estimated on
        the corrupted cloud are garbage — hostile to the normal-angle
        pre-filter by construction.
      "mismatch" — the outlier's dst is the (transformed, noisy) position of
        a DIFFERENT random src point: both endpoints remain real surface
        points, like wrong FPFH/FCGF matches on real scans. Use this for
        realistic correspondence-benchmark fixtures.
      "clustered" — colluding wrong matches (repeated-geometry style):
        outliers form spatially-clustered groups, each group rigidly
        consistent with its own decoy motion dst_i = T_g(T_gt(src_i)) + noise
        — exactly what matching two identical chairs produces (src points on
        chair 1 match dst points on chair 2; the chair1->chair2 motion T_g
        is rigid). Uniform permutation ("mismatch") can never produce such
        consistency structures, so it under-tests the consensus machinery;
        clustered groups vote together in the ratio
        histogram and form rival near-cliques in the consistency graph.
        Group size caps at 60% of the inlier count so the GT consensus
        remains the unique largest one (a decoy out-voting GT would make the
        instance ill-posed for ANY consensus solver, reference included).
    """
    n = src.shape[1]
    k_t, k_noise, k_sel, k_mag, k_sign = jax.random.split(key, 5)
    gt = random_se3(k_t, max_translation=max_translation, dtype=src.dtype)
    dst = transform_points(gt, src)
    dst = dst + jax.random.uniform(
        k_noise, dst.shape, dtype=src.dtype, minval=-noise_bound, maxval=noise_bound
    )

    n_out = int(round(n * outlier_rate))
    perm = jax.random.permutation(k_sel, n)
    outlier_mask = jnp.zeros((n,), bool).at[perm[:n_out]].set(True)
    if outlier_mode == "displace":
        mag = jax.random.uniform(
            k_mag, (3, n), dtype=src.dtype, minval=5.0, maxval=10.0
        )
        sign = jnp.where(
            jax.random.uniform(k_sign, (3, n), dtype=src.dtype) <= 0.5, -1.0, 1.0
        )
        dst = jnp.where(outlier_mask[None, :], dst + sign * mag, dst)
    elif outlier_mode == "mismatch":
        wrong = jax.random.permutation(k_mag, n)
        dst = jnp.where(outlier_mask[None, :], dst[:, wrong], dst)
    elif outlier_mode == "clustered":
        # Host-side numpy (generation is host-pinned anyway —
        # eval/make_dataset.py): greedy capacity-capped nearest-center
        # grouping needs data-dependent control flow a jit would reject.
        src_np = np.asarray(src, np.float64)
        out_idx = np.asarray(perm[:n_out])
        rng = np.random.default_rng(
            int(np.asarray(jax.random.bits(k_mag, dtype=jnp.uint32)))
        )
        n_in = n - n_out
        cap = max(8, int(0.6 * n_in))
        n_groups = max(1, -(-n_out // cap))
        centers = src_np[:, rng.choice(out_idx, size=n_groups, replace=False)]
        # Greedy spatial grouping: each center claims its `cap` nearest
        # still-unassigned outliers — groups are contiguous patches.
        d2 = np.sum(
            (src_np[:, out_idx, None] - centers[:, None, :]) ** 2, axis=0
        )  # (n_out, n_groups)
        group_of = np.full(n_out, -1)
        taken = np.zeros(n_out, bool)
        for g in range(n_groups):
            order = np.argsort(np.where(taken, np.inf, d2[:, g]))
            pick = order[: min(cap, n_out - int(taken.sum()))]
            group_of[pick] = g
            taken[pick] = True
        dst_np = np.asarray(dst, np.float64)
        gt_r = np.asarray(gt.rotation, np.float64)
        gt_t = np.asarray(gt.translation, np.float64)
        noise = np.asarray(
            jax.random.uniform(
                k_sign, (3, n_out), minval=-noise_bound, maxval=noise_bound
            ),
            np.float64,
        )
        for g in range(n_groups):
            members = out_idx[group_of == g]
            if members.size == 0:
                continue
            kg = jax.random.fold_in(k_mag, g + 1)
            decoy = random_se3(kg, max_translation=max_translation,
                               dtype=src.dtype)
            dg_r = np.asarray(decoy.rotation, np.float64)
            dg_t = np.asarray(decoy.translation, np.float64)
            base_pts = gt_r @ src_np[:, members] + gt_t[:, None]
            dst_np[:, members] = dg_r @ base_pts + dg_t[:, None]
        dst_np[:, out_idx] += noise
        dst = jnp.asarray(dst_np, src.dtype)
    else:
        raise ValueError(f"unknown outlier_mode {outlier_mode!r}")
    return SyntheticPair(src=src, dst=dst, transform=gt, outlier_mask=outlier_mask)
