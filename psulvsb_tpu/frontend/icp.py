"""Point-to-point ICP refinement.

Equivalent of the Open3D ICP stage in the FPFH+ICP example pipeline
(/root/reference/examples/teaser_python_fpfh_icp/example.py: TEASER result
refined by o3d registration_icp point-to-point). Batched form:
fixed-iteration `lax.while_loop`, nearest neighbors via the brute-force
matmul kNN, Kabsch
update, convergence on transform delta.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from psulvsb_tpu.core.linalg import weighted_procrustes_srt
from psulvsb_tpu.frontend.knn import knn
from psulvsb_tpu.utils.precision import mm


class ICPResult(NamedTuple):
    rotation: jax.Array
    translation: jax.Array
    iterations: jax.Array
    rmse: jax.Array  # inlier RMSE at convergence


@functools.partial(
    jax.jit, static_argnames=("max_iterations",)
)
def icp_point_to_point(
    src: jax.Array,
    dst: jax.Array,
    init_rotation: jax.Array | None = None,
    init_translation: jax.Array | None = None,
    max_correspondence_distance: float | jax.Array = 0.1,
    max_iterations: int = 30,
    tolerance: float = 1e-6,
    src_active: jax.Array | None = None,
    dst_active: jax.Array | None = None,
) -> ICPResult:
    """Refine alignment of (3, N) src onto (3, M) dst."""
    dtype = src.dtype
    n = src.shape[1]
    if init_rotation is None:
        init_rotation = jnp.eye(3, dtype=dtype)
    if init_translation is None:
        init_translation = jnp.zeros((3,), dtype=dtype)
    if src_active is None:
        src_active = jnp.ones((n,), bool)
    max_d2 = jnp.square(jnp.asarray(max_correspondence_distance, dtype))

    class Carry(NamedTuple):
        r: jax.Array
        t: jax.Array
        i: jax.Array
        done: jax.Array

    def correspond(r, t):
        moved = mm(r, src) + t[:, None]
        idx, d2 = knn(moved, dst, k=1, point_active=dst_active)
        nn = dst[:, idx[:, 0]]
        w = ((d2[:, 0] <= max_d2) & src_active).astype(dtype)
        n_in = jnp.sum(w)
        # No correspondence within range is a DIVERGED state, not a perfect
        # fit: rmse must read inf (a zero-weight Procrustes would otherwise
        # pair a garbage transform with rmse 0.0).
        rmse = jnp.where(
            n_in > 0,
            jnp.sqrt(jnp.sum(d2[:, 0] * w) / jnp.maximum(n_in, 1.0)),
            jnp.asarray(jnp.inf, dtype),
        )
        return nn, w, n_in, rmse

    def body(c: Carry) -> Carry:
        nn, w, n_in, _rmse = correspond(c.r, c.t)
        r_new, t_new = weighted_procrustes_srt(src, nn, w)
        diverged = n_in == 0
        r_new = jnp.where(diverged, c.r, r_new)
        t_new = jnp.where(diverged, c.t, t_new)
        delta = jnp.max(jnp.abs(r_new - c.r)) + jnp.max(jnp.abs(t_new - c.t))
        return Carry(
            r=r_new, t=t_new, i=c.i + 1,
            done=(delta < tolerance) | diverged,
        )

    init = Carry(
        r=init_rotation,
        t=init_translation,
        i=jnp.int32(0),
        done=jnp.zeros((), bool),
    )
    final = jax.lax.while_loop(
        lambda c: (~c.done) & (c.i < max_iterations), body, init
    )
    # Report the residual of the transform actually returned (inside the
    # loop it would lag one update behind).
    _, _, _, rmse_final = correspond(final.r, final.t)
    return ICPResult(
        rotation=final.r,
        translation=final.t,
        iterations=final.i,
        rmse=rmse_final,
    )
