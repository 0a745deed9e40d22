"""Feature correspondence matcher — dense matmul kNN over 33-D descriptors.

Equivalent of teaser::Matcher (matcher.cc:22-335): FLANN kd-trees over FPFH
features, lazy mutual-NN initial matching, optional cross-check, optional
random tuple (triangle scale consistency) test, dedup. The kd-trees become
one (N1, N2) feature-distance matmul per direction; the serial tuple loop
becomes a vectorized batch of random triads.

The reference's initial matching is asymmetric and lazy
(matcher.cc:152-168): every target point j contributes (nn_i(j), j); each
source point i that was ever hit also contributes (i, nn_j(i)).
Replicated exactly — it matters for the no-crosscheck path.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from psulvsb_tpu.frontend.knn import knn


def normalize_points(
    src: np.ndarray, dst: np.ndarray, use_absolute_scale: bool
) -> tuple[np.ndarray, np.ndarray, float]:
    """Mean-center both clouds; divide by the global max point norm unless
    absolute scale is requested (matcher.cc:56-114). Returns
    (src_n, dst_n, global_scale)."""
    out = []
    scale = 0.0
    for pts in (src, dst):
        mean = pts.mean(axis=1, keepdims=True)
        centered = pts - mean
        scale = max(scale, float(np.linalg.norm(centered, axis=0).max()))
        out.append(centered)
    if not use_absolute_scale and scale > 0:
        out = [p / scale for p in out]
    return out[0], out[1], scale


class Matcher:
    """Class facade mirroring teaser::Matcher (matcher.h:18-63)."""

    def calculateCorrespondences(
        self,
        source_points,
        target_points,
        source_features,
        target_features,
        use_absolute_scale: bool = False,
        use_crosscheck: bool = True,
        use_tuple_test: bool = True,
        tuple_scale: float = 0.95,
        seed: int = 0,
    ) -> np.ndarray:
        """Returns (M, 2) int array of (source_idx, target_idx) pairs."""
        return match_features(
            np.asarray(source_points),
            np.asarray(target_points),
            np.asarray(source_features),
            np.asarray(target_features),
            use_absolute_scale=use_absolute_scale,
            use_crosscheck=use_crosscheck,
            use_tuple_test=use_tuple_test,
            tuple_scale=tuple_scale,
            seed=seed,
        )


def match_features(
    source_points: np.ndarray,
    target_points: np.ndarray,
    source_features: np.ndarray,
    target_features: np.ndarray,
    use_absolute_scale: bool = False,
    use_crosscheck: bool = True,
    use_tuple_test: bool = True,
    tuple_scale: float = 0.95,
    seed: int = 0,
) -> np.ndarray:
    """Functional matcher. source/target_points: (3, N); features: (N, 33).

    Heavy stages (feature kNN, triad testing) run jitted; list compaction
    happens in numpy — this is pair preprocessing, not the solve hot loop.
    """
    src_n, dst_n, _ = normalize_points(
        source_points.astype(np.float32), target_points.astype(np.float32),
        use_absolute_scale,
    )

    # The reference reorders so cloud "i" is the one with MORE points
    # (matcher.cc:122-127).
    swapped = dst_n.shape[1] > src_n.shape[1]
    if swapped:
        pts_i, pts_j = dst_n, src_n
        feat_i, feat_j = target_features, source_features
    else:
        pts_i, pts_j = src_n, dst_n
        feat_i, feat_j = source_features, target_features

    fi = jnp.asarray(feat_i, jnp.float32).T  # (33, Ni)
    fj = jnp.asarray(feat_j, jnp.float32).T
    nn_ji, _ = knn(fj, fi, k=1)  # for each j: nearest i
    nn_ij, _ = knn(fi, fj, k=1)  # for each i: nearest j
    nn_ji = np.asarray(nn_ji[:, 0])
    nn_ij = np.asarray(nn_ij[:, 0])

    n_i = pts_i.shape[1]
    corres_ji = np.stack([nn_ji, np.arange(nn_ji.shape[0])], axis=1)  # (i, j)
    hit = np.zeros(n_i, bool)
    hit[nn_ji] = True
    i_idx = np.where(hit)[0]
    corres_ij = np.stack([i_idx, nn_ij[i_idx]], axis=1)

    if use_crosscheck:
        # (i, j) kept iff present in both directions (matcher.cc:184-218).
        mutual = nn_ji[corres_ij[:, 1]] == corres_ij[:, 0]
        corres = corres_ij[mutual]
    else:
        corres = np.concatenate([corres_ij, corres_ji], axis=0)

    if use_tuple_test and tuple_scale != 0 and corres.shape[0] >= 3:
        corres = _tuple_test(
            corres, pts_i, pts_j, tuple_scale, seed=seed
        )

    if swapped:
        corres = corres[:, ::-1]
    # Sort + unique dedup (matcher.cc:301-302).
    corres = np.unique(corres, axis=0)
    return corres


def _tuple_test(
    corres: np.ndarray,
    pts_i: np.ndarray,
    pts_j: np.ndarray,
    tuple_scale: float,
    seed: int,
    chunk: int = 500_000,
) -> np.ndarray:
    """Random triangle scale-consistency test (matcher.cc:225-285): draw
    ncorr*100 random triads of correspondences; a triad passes if all three
    edge-length ratios lie in (tuple_scale, 1/tuple_scale); pairs in any
    passing triad survive. The full ncorr*100 trials always run (reference
    parity); `chunk` only bounds peak memory per batch of triads."""
    ncorr = corres.shape[0]
    trials = ncorr * 100
    key = jax.random.PRNGKey(seed)

    ci = jnp.asarray(corres[:, 0])
    cj = jnp.asarray(corres[:, 1])
    pi = jnp.asarray(pts_i, jnp.float32)
    pj = jnp.asarray(pts_j, jnp.float32)

    def edges(p):  # (3, T, 3) -> (T, 3) edge lengths
        e0 = jnp.linalg.norm(p[:, :, 0] - p[:, :, 1], axis=0)
        e1 = jnp.linalg.norm(p[:, :, 1] - p[:, :, 2], axis=0)
        e2 = jnp.linalg.norm(p[:, :, 2] - p[:, :, 0], axis=0)
        return jnp.stack([e0, e1, e2], axis=1)

    keep = jnp.zeros((ncorr,), bool)
    for start in range(0, trials, chunk):
        t = min(chunk, trials - start)
        key, sub = jax.random.split(key)
        triads = jax.random.randint(sub, (t, 3), 0, ncorr)
        ti = ci[triads]  # (T, 3) indices into pts_i
        tj = cj[triads]
        a = pi[:, ti]  # (3, T, 3)
        b = pj[:, tj]
        li = edges(a)
        lj = edges(b)
        ok = jnp.all((li * tuple_scale < lj) & (lj < li / tuple_scale), axis=1)
        keep = keep.at[triads.reshape(-1)].max(jnp.repeat(ok, 3))
    keep = np.asarray(keep)
    return corres[keep]
