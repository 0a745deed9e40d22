"""Core linear algebra for batched registration.

Point-set convention: ``(3, N)`` matrices ("points as columns"), matching the
reference API, and keeping N on the trailing (contiguous) axis so vector
ops over N points run over dense rows.

Functional equivalents of (all references into /root/reference/):
- ``teaser::utils::svdRot``            teaser/include/teaser/utils.h:121-136
- ``teaser::hatmap``                   teaser/include/teaser/linalg.h:24-32
- ``teaser::vectorKron``               teaser/include/teaser/linalg.h:43-72
- ``teaser::getNearestPSD``            teaser/include/teaser/linalg.h:84-99

The rotation-from-correlation solve additionally offers a branch-free
quaternion (Davenport/Horn) path that is friendlier to batched execution
than a general SVD: building the symmetric 4x4 Davenport matrix and taking its
leading eigenvector yields exactly the Kabsch/Umeyama proper rotation
(including the reflection fix) without any data-dependent sign branch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from psulvsb_tpu.utils.precision import mm


def hatmap(v: jax.Array) -> jax.Array:
    """Skew-symmetric (hat) map of a 3-vector. Ref linalg.h:24-32."""
    z = jnp.zeros((), dtype=v.dtype)
    return jnp.stack(
        [
            jnp.stack([z, -v[2], v[1]]),
            jnp.stack([v[2], z, -v[0]]),
            jnp.stack([-v[1], v[0], z]),
        ]
    )


def vector_kron(a: jax.Array, b: jax.Array) -> jax.Array:
    """Column-wise Kronecker product of two (d, N) matrices -> (d*d, N).

    Ref linalg.h:43-72 (there OpenMP-collapsed loops; here one outer product
    broadcast the VPU vectorizes over N).
    """
    d1, n = a.shape
    d2, n2 = b.shape
    assert n == n2
    return (a[:, None, :] * b[None, :, :]).reshape(d1 * d2, n)


def nearest_psd(a: jax.Array) -> jax.Array:
    """Project a symmetric matrix to the PSD cone by eigenvalue clamping.

    Ref linalg.h:84-99.
    """
    sym = (a + a.T) / 2
    w, v = jnp.linalg.eigh(sym)
    w = jnp.maximum(w, 0)
    return mm(v * w[None, :], v.T)


def _davenport_matrix(s: jax.Array) -> jax.Array:
    """Davenport K matrix from the 3x3 correlation S = sum_i w_i x_i y_i^T.

    The max-eigenvector of K is the unit quaternion q = (w, x, y, z) of the
    proper rotation R maximizing sum_i w_i <R x_i, y_i>  (Horn 1987).
    """
    sxx, sxy, sxz = s[0, 0], s[0, 1], s[0, 2]
    syx, syy, syz = s[1, 0], s[1, 1], s[1, 2]
    szx, szy, szz = s[2, 0], s[2, 1], s[2, 2]
    return jnp.array(
        [
            [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
            [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
            [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
            [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz],
        ]
    )


def _quat_to_rot(q: jax.Array) -> jax.Array:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rot_from_correlation(h: jax.Array, method: str = "eigh") -> jax.Array:
    """Proper rotation R maximizing tr(R^T H) for H = sum_i w_i x_i y_i^T.

    Equivalent to Kabsch SVD with reflection fix (ref utils.h:121-136) but
    branch-free: quaternion from the leading eigenvector of the 4x4
    Davenport matrix.

    method:
      "eigh"  — jnp.linalg.eigh on the 4x4 (accurate; batches fine).
      "power" — shifted power iteration, pure matmuls (fastest inside big
                vmapped GNC loops; ~30 iterations).
    """
    k = _davenport_matrix(h)
    if method == "eigh":
        _, vecs = jnp.linalg.eigh(k)
        q = vecs[:, -1]
    elif method == "power":
        # Shift to make the max eigenvalue dominant in magnitude. Unrolled
        # (no fori_loop): inside vmapped GNC while_loops a device loop would
        # cost ~30 sequential kernel launches per GNC iteration; unrolled,
        # XLA fuses the chain. Squaring the operand (K <- K @ K / ||.||)
        # doubles the effective iteration count per matmul: 5 squarings
        # ~ 2^5 = 32 plain power steps.
        shift = 2.0 * jnp.sqrt(jnp.sum(h * h)) + 1e-12
        ks = k + shift * jnp.eye(4, dtype=k.dtype)
        for _ in range(5):
            ks = mm(ks, ks)
            ks = ks / (jnp.sqrt(jnp.sum(ks * ks)) + 1e-30)
        # The converged Ks is (near) rank-1 lambda*v*v^T; its largest-norm
        # column is a scaled copy of the dominant eigenvector v regardless
        # of orientation (max |v_j| >= 1/2 for unit v). A fixed probe like
        # (0.5,)*4 collapses when v is orthogonal to the all-ones direction
        # (e.g. 180-degree rotations with near-zero quaternion component
        # sums, common in symmetric scenes).
        q = ks[:, jnp.argmax(jnp.sum(ks * ks, axis=0))]
    else:
        raise ValueError(f"unknown method {method!r}")
    return _quat_to_rot(q / (jnp.linalg.norm(q) + 1e-30))


def svd_rot(
    x: jax.Array,
    y: jax.Array,
    w: jax.Array | None = None,
    method: str = "eigh",
) -> jax.Array:
    """Weighted Procrustes: rotation R with y ≈ R x (both (3, N)).

    Functional equivalent of teaser::utils::svdRot (utils.h:121-136): the
    reference computes H = X W Y^T, SVD, and flips the last column of V when
    det(U)det(V) < 0; the quaternion path here produces the identical proper
    rotation without the branch. Padded/inactive columns are handled by
    zero weights.
    """
    if w is None:
        w = jnp.ones((x.shape[1],), dtype=x.dtype)
    h = mm(x * w[None, :], y.T)  # (3,3): S_ab = sum_i w_i x_a y_b
    return rot_from_correlation(h, method=method)


@functools.partial(jax.jit, static_argnames=("method",))
def weighted_procrustes_srt(
    src: jax.Array,
    dst: jax.Array,
    w: jax.Array,
    method: str = "eigh",
) -> tuple[jax.Array, jax.Array]:
    """Weighted rigid fit (R, t) minimizing sum_i w_i ||R src_i + t - dst_i||^2.

    Equivalent of the reference's weightedSVD core (registration.cc:526-569)
    minus the transform composition (done by the caller). src/dst: (3, N).
    """
    total = jnp.sum(w) + 1e-30
    c_src = mm(src, w) / total
    c_dst = mm(dst, w) / total
    xs = src - c_src[:, None]
    ys = dst - c_dst[:, None]
    h = mm(xs * w[None, :], ys.T)
    r = rot_from_correlation(h, method=method)
    t = c_dst - mm(r, c_src)
    return r, t


# --- small teaser::utils parity helpers (utils.h:31-171) ---------------------


def random_sample(key: jax.Array, n: int, k: int) -> jax.Array:
    """k distinct indices from [0, n) — utils::randomSample (utils.h:31-56;
    the reference's rejection loop becomes a permutation slice)."""
    return jax.random.permutation(key, n)[:k]


def mask_vector(mask, elements):
    """utils::maskVector (utils.h:144-157): keep elements where mask is
    True. Host-side helper (dynamic output size)."""
    import numpy as np

    mask = np.asarray(mask, bool)
    return [e for e, m in zip(elements, mask) if m]


def find_nonzero(mask) -> "list[int]":
    """utils::findNonzero (utils.h:164-171). Host-side helper."""
    import numpy as np

    return [int(i) for i in np.nonzero(np.asarray(mask))[0]]


def remove_columns(arr, cols):
    """utils::removeColumn generalization (utils.h:58-105). Host-side."""
    import numpy as np

    keep = np.ones(np.asarray(arr).shape[1], bool)
    keep[list(cols)] = False
    return np.asarray(arr)[:, keep]
