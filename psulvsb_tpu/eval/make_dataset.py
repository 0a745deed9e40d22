"""Reference-format benchmark dataset generator.

The real-data harness (eval/realdata.py) consumes the exact on-disk layout
the reference's 3DMatch/3DLoMatch/KITTI driver reads
(teaser_cpp_ply_main.cc:263-295): per scene a `pairs.txt` label list, and
per pair `cloud_bin_A+cloud_bin_B@corr.txt` ("sx sy sz tx ty tz" rows) +
`cloud_bin_A+cloud_bin_B@GTmat.txt` (4x4), plus a standard `gt.log`.

No dataset ships in this image, so this module synthesizes scenes in that
format at realistic sizes: >= 1k correspondences per pair, fcgf/fpfh-style
outlier rates (wrong-match "mismatch" outliers, 60-95%), hostile random
rotations (up to 180 deg), translations at scene scale. The harness and its
recall accounting then run exactly as they would on the real archives.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.eval.synthetic import synthetic_cloud, make_synthetic_pair


def _gt_matrix(rotation: np.ndarray, translation: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = rotation
    m[:3, 3] = translation
    return m


def write_scene(
    scene_dir: str,
    n_pairs: int = 6,
    n_corr: int | tuple[int, ...] = 1500,
    outlier_rates: tuple[float, ...] = (0.6, 0.75, 0.85, 0.9, 0.93, 0.95),
    noise_bound: float = 0.01,
    scene_scale: float = 1.0,
    max_translation: float = 2.0,
    seed: int = 0,
    descriptor: str = "fpfh",
    outlier_mode: str = "mismatch",
) -> list[tuple[int, int]]:
    """Write one reference-format scene directory; returns the pair labels.

    Pair i uses outlier_rates[i % len] with a fresh random SE(3) whose
    rotation is unconstrained (hostile large-angle cases included by
    construction — random_se3 draws the angle uniform over [0, pi)).

    n_corr may be a tuple — pair cardinality then cycles through it, which
    is what real FPFH/FCGF extraction produces (cardinality varies with
    overlap) and what exercises several pad buckets inside one scene sweep
    (utils/padding.DEFAULT_PAD_BUCKETS). The size index advances by one
    extra step per full outlier-rate cycle, so when len(n_corr) divides
    len(outlier_rates) a given size still sees every rate over the scene —
    otherwise size would be confounded with difficulty (the largest bucket
    would always get the hardest pairs)."""
    os.makedirs(scene_dir, exist_ok=True)
    suffix = "@corr.txt" if descriptor == "fpfh" else "@corr_fcgf.txt"
    gt_suffix = "@GTmat.txt" if descriptor == "fpfh" else "@GTmat_fcgf.txt"

    sizes = (n_corr,) if isinstance(n_corr, int) else tuple(n_corr)
    bases = {
        n: np.asarray(synthetic_cloud(n, seed=seed)) * scene_scale
        for n in sorted(set(sizes))
    }
    labels = []
    gt_log_blocks = []
    # Generation is many tiny ops; pinned to the host CPU device so they
    # do not each pay an accelerator dispatch.
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    for i in range(n_pairs):
        a, b = i, i + 1
        rate = outlier_rates[i % len(outlier_rates)]
        base = bases[sizes[(i + i // len(outlier_rates)) % len(sizes)]]
        with jax.default_device(cpu):
            pair = make_synthetic_pair(
                jax.random.PRNGKey(seed * 1000 + i),
                jnp.asarray(base, jnp.float32),
                noise_bound=noise_bound,
                outlier_rate=rate,
                max_translation=max_translation,
                outlier_mode=outlier_mode,
            )
        src = np.asarray(pair.src, np.float64)
        dst = np.asarray(pair.dst, np.float64)
        gt = _gt_matrix(
            np.asarray(pair.transform.rotation, np.float64),
            np.asarray(pair.transform.translation, np.float64),
        )
        stem = os.path.join(scene_dir, f"cloud_bin_{a}+cloud_bin_{b}")
        np.savetxt(stem + suffix, np.concatenate([src, dst]).T, fmt="%.8f")
        np.savetxt(stem + gt_suffix, gt, fmt="%.10f")
        labels.append((a, b))
        gt_log_blocks.append(
            f"{a} {b} {n_pairs + 1}\n"
            + "\n".join(" ".join(f"{v:.10f}" for v in row) for row in gt)
        )

    with open(os.path.join(scene_dir, "pairs.txt"), "w") as f:
        f.write("\n".join(f"{a} {b}" for a, b in labels) + "\n")
    with open(os.path.join(scene_dir, "gt.log"), "w") as f:
        f.write("\n".join(gt_log_blocks) + "\n")
    return labels


def write_benchmark(
    data_root: str,
    scenes: list[str],
    dataset: str = "3dmatch",
    n_pairs: int | dict[str, int] = 6,
    n_corr: int | tuple[int, ...] = 1500,
    seed: int = 0,
    outlier_rates: tuple[float, ...] | None = None,
    outlier_mode: str = "mismatch",
) -> None:
    """Write a multi-scene benchmark tree under data_root.

    n_pairs may be a {scene: count} dict — the real 3DMatch benchmark has
    unequal per-scene pair counts (506 redkitchen ... 54 hotel3, summing to
    its published 1623; tools/fullscale_sweep.py uses this).

    dataset presets follow the reference's per-dataset regimes: 3DMatch
    (room scale ~ meters, noise bound 0.01), 3DLoMatch (same rooms, low
    overlap -> 85-98% mismatch outliers), KITTI (outdoor scale, noise bound
    0.1, translations up to ~10 m — teaser_cpp_ply_main.cc:700-720),
    WHU-TLS (building-scale terrestrial scans, noise bound 0.15 —
    registration.cc:35's commented preset)."""
    if dataset == "kitti":
        kw = dict(noise_bound=0.1, scene_scale=20.0, max_translation=10.0)
    elif dataset == "whu_tls":
        kw = dict(noise_bound=0.15, scene_scale=30.0, max_translation=15.0)
    else:
        kw = dict(noise_bound=0.01, scene_scale=1.0, max_translation=2.0)
    if dataset == "3dlomatch" and outlier_rates is None:
        outlier_rates = (0.85, 0.9, 0.93, 0.95, 0.97, 0.98)
    if outlier_rates is not None:
        kw["outlier_rates"] = outlier_rates
    for si, scene in enumerate(scenes):
        write_scene(
            os.path.join(data_root, scene),
            n_pairs=n_pairs[scene] if isinstance(n_pairs, dict) else n_pairs,
            n_corr=n_corr,
            seed=seed + 17 * si,
            outlier_mode=outlier_mode,
            **kw,
        )
