"""FPFH-33 descriptors — gather/histogram kernels on fixed-K neighborhoods.

Equivalent of teaser::FPFHEstimation (fpfh.cc:15-43, a PCL wrapper:
kd-tree radius search -> SPFH pair-feature histograms -> distance-weighted
neighbor pooling). Batched form:

- neighborhoods: brute-force kNN (matmul) with a radius mask (PCL uses pure
  radius search; a K-cap with radius masking keeps shapes static),
- Darboux pair features (f1 = atan2(w.n_t, n_s.n_t), f2 = v.n_t,
  f3 = n_s.d/|d|) computed for all (point, neighbor) lanes at once,
- SPFH: 3 x 11-bin histograms per point via one-hot scatter-add, each
  neighbor contributing 100/n_neighbors (PCL's hist_incr),
- FPFH(p) = SPFH(p) + (1/K) sum_k (1/d_k^2) SPFH(q_k) (Rusu et al.; PCL
  weights by the squared neighbor distance), then each 11-bin block
  renormalized to sum 100.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from psulvsb_tpu.frontend.knn import knn

_HIGHEST = jax.lax.Precision.HIGHEST


def pair_features(
    p1: jax.Array, n1: jax.Array, p2: jax.Array, n2: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Darboux-frame pair features, vectorized over trailing axes.

    p1/n1/p2/n2: (..., 3). Returns (f1, f2, f3, dist, valid) with the PCL
    source/target swap rule (the point whose normal is better aligned with
    the connecting line becomes the source).
    """
    d = p2 - p1
    dist = jnp.linalg.norm(d, axis=-1)
    safe = jnp.maximum(dist, 1e-20)
    a1 = jnp.sum(n1 * d, axis=-1) / safe
    a2 = jnp.sum(n2 * d, axis=-1) / safe
    swap = jnp.abs(a1) < jnp.abs(a2)  # acos(|a1|) > acos(|a2|)

    ns = jnp.where(swap[..., None], n2, n1)
    nt = jnp.where(swap[..., None], n1, n2)
    ds = jnp.where(swap[..., None], -d, d)
    f3 = jnp.where(swap, -a2, a1)

    v = jnp.cross(ds, ns)
    v_norm = jnp.linalg.norm(v, axis=-1)
    valid = (dist > 1e-12) & (v_norm > 1e-12)
    v = v / jnp.maximum(v_norm, 1e-20)[..., None]
    w = jnp.cross(ns, v)
    f2 = jnp.sum(v * nt, axis=-1)
    f1 = jnp.arctan2(jnp.sum(w * nt, axis=-1), jnp.sum(ns * nt, axis=-1))
    return f1, f2, f3, dist, valid


def _bin11(f: jax.Array, lo: float, hi: float) -> jax.Array:
    idx = jnp.floor(11.0 * (f - lo) / (hi - lo)).astype(jnp.int32)
    return jnp.clip(idx, 0, 10)


@functools.partial(jax.jit, static_argnames=("k",))
def compute_fpfh(
    points: jax.Array,
    normals: jax.Array,
    radius: float | jax.Array,
    k: int = 64,
    active: jax.Array | None = None,
) -> jax.Array:
    """FPFH-33 features of a (3, N) cloud with (3, N) normals.

    radius: neighborhood radius (PCL setRadiusSearch); neighbors are the k
    nearest within the radius. Returns (N, 33) float32.
    """
    n = points.shape[1]
    if active is None:
        active = jnp.ones((n,), bool)

    idx, sqd = knn(points, points, k=min(k + 1, n), point_active=active)
    # Drop self (first column) and mask by radius.
    idx = idx[:, 1:]
    sqd = sqd[:, 1:]
    kk = idx.shape[1]
    r2 = jnp.square(jnp.asarray(radius, points.dtype))
    nb_ok = (sqd <= r2) & active[idx] & active[:, None]

    p1 = points.T[:, None, :]  # (N, 1, 3)
    n1 = normals.T[:, None, :]
    p2 = points.T[idx]  # (N, K, 3)
    n2 = normals.T[idx]
    f1, f2, f3, _, valid = pair_features(
        jnp.broadcast_to(p1, p2.shape), jnp.broadcast_to(n1, n2.shape), p2, n2
    )
    ok = nb_ok & valid  # (N, K)

    b1 = _bin11(f1, -jnp.pi, jnp.pi)
    b2 = _bin11(f2, -1.0, 1.0)
    b3 = _bin11(f3, -1.0, 1.0)

    n_nb = jnp.maximum(jnp.sum(ok, axis=1), 1).astype(points.dtype)  # (N,)
    incr = (100.0 / n_nb)[:, None] * ok.astype(points.dtype)  # (N, K)

    def hist(bins):
        onehot = jax.nn.one_hot(bins, 11, dtype=points.dtype)  # (N, K, 11)
        return jnp.einsum("nk,nkb->nb", incr, onehot, precision=_HIGHEST)

    spfh = jnp.concatenate([hist(b1), hist(b2), hist(b3)], axis=1)  # (N, 33)

    # Distance-weighted neighbor pooling.
    w = jnp.where(ok, 1.0 / jnp.maximum(sqd, 1e-12), 0.0)  # (N, K)
    neighbor_sum = jnp.einsum("nk,nkf->nf", w, spfh[idx], precision=_HIGHEST)
    fpfh = spfh + neighbor_sum / n_nb[:, None]

    # Renormalize each 11-bin block to sum 100 (PCL convention).
    blocks = fpfh.reshape(n, 3, 11)
    sums = jnp.maximum(jnp.sum(blocks, axis=2, keepdims=True), 1e-12)
    out = (blocks / sums * 100.0).reshape(n, 33)
    return jnp.where(active[:, None], out, 0.0)


class FPFHEstimation:
    """Class facade mirroring teaser::FPFHEstimation (fpfh.h:22-83)."""

    def __init__(self, normal_k: int = 20, neighbor_cap: int = 64):
        self.normal_k = normal_k
        self.neighbor_cap = neighbor_cap

    def computeFPFHFeatures(
        self, points, normal_search_radius: float, fpfh_search_radius: float
    ):
        """Mirror of computeFPFHFeatures(cloud, normal_radius, fpfh_radius)
        (fpfh.cc:15-43). Returns (N, 33) features."""
        import numpy as np
        from psulvsb_tpu.frontend.normals import estimate_normals

        pts = jnp.asarray(np.asarray(points), jnp.float32)
        # Radius-bounded normals like the reference's setRadiusSearch
        # (fpfh.cc:30); normal_k caps the neighborhood size.
        normals = estimate_normals(
            pts, k=self.normal_k, radius=float(normal_search_radius)
        )
        return compute_fpfh(
            pts, normals, fpfh_search_radius, k=self.neighbor_cap
        )
