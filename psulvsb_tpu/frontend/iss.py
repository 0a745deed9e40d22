"""ISS (Intrinsic Shape Signature) keypoint detection.

Equivalent of the PCL ISSKeypoint3D stage in the correspondence generator
(/root/reference/TEASER-plusplus/examples/teaser_cpp_ply/teaser_cpp_ply.cc:
113-139: salient radius 6r, non-max radius 4r, gamma_21 = gamma_32 = 0.975,
min_neighbors = 5). Batched form: kNN neighborhoods with radius masks, batched
3x3 eigendecompositions, neighborhood-max suppression on the smallest
eigenvalue.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from psulvsb_tpu.frontend.knn import knn

_HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("k",))
def iss_keypoints(
    points: jax.Array,
    salient_radius: float,
    non_max_radius: float,
    gamma_21: float = 0.975,
    gamma_32: float = 0.975,
    min_neighbors: int = 5,
    k: int = 64,
    active: jax.Array | None = None,
) -> jax.Array:
    """Returns (N,) bool keypoint mask for a (3, N) cloud."""
    n = points.shape[1]
    if active is None:
        active = jnp.ones((n,), bool)
    dtype = points.dtype

    idx, sqd = knn(points, points, k=min(k, n), point_active=active)
    in_salient = (sqd <= salient_radius**2) & active[idx]

    # Weighted scatter covariance (ISS weights = 1/#neighbors of each
    # neighbor; PCL uses inverse local density — the plain covariance is the
    # standard simplification and changes little on uniform clouds).
    neigh = points.T[idx]  # (N, K, 3)
    w = in_salient.astype(dtype)
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mean = jnp.einsum("nk,nkd->nd", w, neigh, precision=_HIGHEST) / cnt[:, None]
    cen = (neigh - mean[:, None, :]) * w[:, :, None]
    cov = jnp.einsum("nkd,nke->nde", cen, cen, precision=_HIGHEST) / cnt[:, None, None]
    evals = jnp.linalg.eigvalsh(cov)  # ascending: l3, l2, l1
    l3, l2, l1 = evals[:, 0], evals[:, 1], evals[:, 2]

    ok = (
        (l2 / jnp.maximum(l1, 1e-30) < gamma_21)
        & (l3 / jnp.maximum(l2, 1e-30) < gamma_32)
        & (jnp.sum(in_salient, axis=1) >= min_neighbors)
        & (l3 > 0)
        & active
    )

    # Non-max suppression on l3 within non_max_radius.
    in_nms = (sqd <= non_max_radius**2) & active[idx]
    sal = jnp.where(ok, l3, -jnp.inf)
    neigh_sal = jnp.where(in_nms, sal[idx], -jnp.inf)
    local_max = sal >= jnp.max(neigh_sal, axis=1)
    return ok & local_max
