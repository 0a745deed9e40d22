"""Pure metric functions shared by the solver and the eval harness.

Equivalents of (references into /root/reference/):
- getAngularError                    examples/teaser_cpp_ply/PSULVSB.cc:30-33
- calculateRMSE                      teaser/src/registration.cc:571-602
- computeInlierProbability           teaser/src/registration.cc:611-619
- utils::calculateDiameter           teaser/include/teaser/utils.h:107-112
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from psulvsb_tpu.utils.precision import mm


def angular_error_rad(r_exp: jax.Array, r_est: jax.Array) -> jax.Array:
    """Geodesic rotation error |acos((tr(Ra^T Rb) - 1)/2)| in radians."""
    c = (jnp.trace(mm(r_exp.T, r_est)) - 1.0) / 2.0
    return jnp.abs(jnp.arccos(jnp.clip(c, -1.0, 1.0)))


def angular_error_deg(r_exp: jax.Array, r_est: jax.Array) -> jax.Array:
    return angular_error_rad(r_exp, r_est) * (180.0 / jnp.pi)


def angular_error_deg_np(r_exp, r_est) -> float:
    """Host-only (numpy, f64) geodesic rotation error in degrees.

    The eval harnesses score thousands of (pair, retry) results per sweep;
    a jnp call per result costs a device dispatch each. Scoring is
    host-side bookkeeping, not solver compute, so it stays on the host."""
    import numpy as np

    a = np.asarray(r_exp, np.float64)
    b = np.asarray(r_est, np.float64)
    c = (np.trace(a.T @ b) - 1.0) / 2.0
    return float(abs(np.arccos(min(1.0, max(-1.0, c)))) * (180.0 / np.pi))


def translation_error(t_exp: jax.Array, t_est: jax.Array) -> jax.Array:
    return jnp.linalg.norm(t_exp - t_est)


def masked_rmse(
    src: jax.Array,
    dst: jax.Array,
    mask: jax.Array,
    rotation: jax.Array,
    translation: jax.Array,
    scale: jax.Array | float = 1.0,
) -> jax.Array:
    """RMSE of s*(R src + t) vs dst over mask==True columns. src/dst: (3, N).

    Equivalent of calculateRMSE (registration.cc:571-602); the no-inlier case
    (reference throws) returns +inf so the refinement gate rejects. The
    reference's version is scale-blind (it only ever runs it at known
    scale); the optional `scale` generalizes it to the solver's
    s*(R p + t) model and is 1.0 everywhere the reference semantics apply.
    """
    m = mask.astype(src.dtype)
    diff = jnp.asarray(scale, src.dtype) * (
        mm(rotation, src) + translation[:, None]
    ) - dst
    sq = jnp.sum(diff * diff, axis=0)
    count = jnp.sum(m)
    mse = jnp.sum(sq * m) / jnp.maximum(count, 1.0)
    return jnp.where(count > 0, jnp.sqrt(mse), jnp.inf)


def inlier_probability(residual: jax.Array, sigma: jax.Array | float) -> jax.Array:
    """P(inlier) = 1 - P(3/2, r^2 / (2 sigma^2)) — the chi(3) survival
    function via the regularized lower incomplete gamma function.

    Equivalent of computeInlierProbability (registration.cc:611-619, which
    uses boost::math::gamma_p).
    """
    z = (residual * residual) / (2.0 * sigma * sigma)
    return 1.0 - jax.scipy.special.gammainc(1.5, z)


def calculate_diameter(pts: jax.Array, mask: jax.Array | None = None) -> jax.Array:
    """2 * max distance from centroid, over active columns. Ref utils.h:107-112."""
    if mask is None:
        mask = jnp.ones((pts.shape[1],), dtype=bool)
    m = mask.astype(pts.dtype)
    count = jnp.maximum(jnp.sum(m), 1.0)
    cog = mm(pts, m) / count
    d2 = jnp.sum((pts - cog[:, None]) ** 2, axis=0)
    d2 = jnp.where(mask, d2, 0.0)
    return 2.0 * jnp.sqrt(jnp.max(d2))
