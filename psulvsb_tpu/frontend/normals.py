"""Surface normal estimation — kNN + batched covariance eigendecomposition.

Equivalent of the drivers' PCL normal estimation (compute_normal,
/root/reference/examples/teaser_cpp_ply/PSULVSB.cc:35-85: kd-tree kSearch
k=20, or radius search for KITTI). Here: brute-force kNN (matmul) and one
batched 3x3 eigh — the normal is the smallest-eigenvalue eigenvector of the
neighborhood covariance, PCL's exact definition.

PCL orients normals toward the viewpoint (origin by default); replicated so
the downstream src/dst normal-angle histogram sees the same sign convention.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from psulvsb_tpu.frontend.knn import knn


@functools.partial(jax.jit, static_argnames=("k",))
def estimate_normals(
    points: jax.Array,
    k: int = 20,
    active: jax.Array | None = None,
    viewpoint: jax.Array | None = None,
    radius: float | None = None,
) -> jax.Array:
    """Normals of a (3, N) cloud via neighborhood PCA. Returns (3, N).

    radius: when given, the neighborhood is the radius search the reference
    uses (setRadiusSearch, fpfh.cc:30), bounded by the k nearest — neighbors
    beyond the radius are excluded from the covariance. Without it, plain
    kNN (the PSULVSB.cc:52 KSearch(20) driver form).
    """
    n = points.shape[1]
    if active is None:
        active = jnp.ones((n,), bool)
    if viewpoint is None:
        viewpoint = jnp.zeros((3,), points.dtype)

    idx, d2 = knn(points, points, k, point_active=active)  # (N, k) incl. self
    neigh = points[:, idx]  # (3, N, k)
    if radius is not None:
        w = (d2 <= jnp.asarray(radius, points.dtype) ** 2).astype(points.dtype)
        # Self-neighbor (d2 = 0) is always in range, so count >= 1.
        cnt = jnp.sum(w, axis=1)[:, None]  # (N, 1)
        mean = jnp.sum(neigh * w[None], axis=2, keepdims=True) / cnt[None]
        centered = (neigh - mean) * w[None]
        cov = jnp.einsum(
            "ink,jnk->nij", centered, centered,
            precision=jax.lax.Precision.HIGHEST,
        ) / cnt[:, :, None]
    else:
        mean = jnp.mean(neigh, axis=2, keepdims=True)
        centered = neigh - mean  # (3, N, k)
        # (N, 3, 3) covariance batch.
        cov = jnp.einsum(
            "ink,jnk->nij", centered, centered,
            precision=jax.lax.Precision.HIGHEST,
        ) / k
    _, vecs = jnp.linalg.eigh(cov)
    normal = vecs[:, :, 0].T  # smallest eigenvalue -> first column; (3, N)

    # Orient toward viewpoint (PCL flipNormalTowardsViewpoint).
    to_vp = viewpoint[:, None] - points
    flip = jnp.sum(normal * to_vp, axis=0) < 0
    normal = jnp.where(flip[None, :], -normal, normal)
    norm = jnp.linalg.norm(normal, axis=0, keepdims=True)
    return normal / jnp.maximum(norm, 1e-30)
