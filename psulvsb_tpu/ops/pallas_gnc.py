"""Whole-GNC Pallas kernel (Triton route): the full graduated-non-convexity
reweighting loop for one hypothesis per program.

The GNC-TLS rotation solver (rotation/gnc.py, equivalent of
registration.cc:1563-1692) iterates up to 100 times. As XLA ops under a
vmapped `lax.while_loop`, every iteration is a dozen small kernels plus a
loop predicate read back by the host. Here the entire loop — weighted
Procrustes via the Davenport quaternion (matrix-squaring power iteration),
residuals, TLS weight update, convergence bookkeeping — runs inside one
program with all state in registers.

Layout: grid = (B,), one program per hypothesis. The TIM columns of a
hypothesis are seven (Np,) rows (src xyz, dst xyz, active) with Np the
next power of two >= N (Triton blocks are powers of two); padded columns
are inactive and never vote. Per-hypothesis scalars (squared noise bound,
warm flag, warm rotation) arrive as one (16,) row.

Numerics match rotation/gnc.py with rot_method="power" (same update rules,
warm start, degenerate-mu break, cost-uses-previous-weights convention);
parity is tested in tests/test_pallas_ops.py in interpret mode and on the
card by eval/kernel_checks.check_gnc_kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Per-hypothesis scalar row: [nb_sq, use_warm, warm R (9, row-major), pad].
_NPAR = 16


def padded_width(n: int) -> int:
    """Column count the kernel runs at: the next power of two >= max(n, 16)."""
    return max(16, pl.next_power_of_2(n))


def _mat4_mul(a: list, b: list) -> list:
    """4x4 matmul on lists of 16 row-major scalars."""
    out = []
    for i in range(4):
        for j in range(4):
            acc = a[4 * i] * b[j]
            for m in range(1, 4):
                acc = acc + a[4 * i + m] * b[4 * m + j]
            out.append(acc)
    return out


def _davenport_from_h(h: list) -> list:
    """h: 9 row-major correlation entries -> the Davenport K as 16 entries
    (core/linalg._davenport_matrix, rows/cols in (w, x, y, z) order)."""
    sxx, sxy, sxz, syx, syy, syz, szx, szy, szz = h
    return [
        sxx + syy + szz, syz - szy, szx - sxz, sxy - syx,
        syz - szy, sxx - syy - szz, sxy + syx, szx + sxz,
        szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy,
        sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz,
    ]


def _quat_to_r9(q: list) -> list:
    """(w, x, y, z) -> 9 row-major rotation entries."""
    w, x, y, z = q
    return [
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ]


def _rot_from_h9(h: list) -> list:
    """Proper rotation from 9 correlation scalars via shifted
    matrix-squaring power iteration on the Davenport matrix
    (core/linalg.rot_from_correlation method='power')."""
    k = _davenport_from_h(h)
    h_sq = h[0] * h[0]
    for e in h[1:]:
        h_sq = h_sq + e * e
    shift = 2.0 * jnp.sqrt(h_sq) + 1e-12
    ks = [k[i] + shift if i % 5 == 0 else k[i] for i in range(16)]
    for _ in range(5):
        ks = _mat4_mul(ks, ks)
        nrm = ks[0] * ks[0]
        for e in ks[1:]:
            nrm = nrm + e * e
        inv = 1.0 / (jnp.sqrt(nrm) + 1e-30)
        ks = [e * inv for e in ks]
    # q = largest-norm column of the converged (rank-1) Ks, first on ties
    # (the argmax of core/linalg.py 'power').
    col_n = [
        ks[c] * ks[c] + ks[4 + c] * ks[4 + c]
        + ks[8 + c] * ks[8 + c] + ks[12 + c] * ks[12 + c]
        for c in range(4)
    ]
    best_n = col_n[0]
    q = [ks[0], ks[4], ks[8], ks[12]]
    for c in range(1, 4):
        take = col_n[c] > best_n
        q = [jnp.where(take, ks[4 * i + c], q[i]) for i in range(4)]
        best_n = jnp.maximum(col_n[c], best_n)
    qn = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    inv = 1.0 / (jnp.sqrt(qn) + 1e-30)
    return _quat_to_r9([e * inv for e in q])


def _kernel(sx_ref, sy_ref, sz_ref, dx_ref, dy_ref, dz_ref, act_ref, par_ref,
            rot_ref, w_ref, *, max_iterations, gnc_factor, cost_threshold):
    s = (sx_ref[...], sy_ref[...], sz_ref[...])  # each (Np,)
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    act = act_ref[...]  # (Np,) float {0, 1}
    live_col = act > 0.5
    par = par_ref[...]
    lane = jax.lax.broadcasted_iota(jnp.int32, (_NPAR,), 0)

    def scalar(k):
        return jnp.sum(jnp.where(lane == k, par, 0.0))

    nbsq = scalar(0)
    use_warm = scalar(1) > 0.5
    warm = [scalar(2 + k) for k in range(9)]

    def residuals_sq(r):
        out = None
        for i in range(3):
            e = d[i] - (r[3 * i] * s[0] + r[3 * i + 1] * s[1] + r[3 * i + 2] * s[2])
            out = e * e if out is None else out + e * e
        return out

    def body(state):
        i, r9, w, mu, prev_cost, done = state
        wa = w * act
        h = [jnp.sum(wa * s[a] * d[b]) for a in range(3) for b in range(3)]
        solved = _rot_from_h9(h)
        take_warm = (i == 0) & use_warm
        rot = [jnp.where(take_warm, warm[k], solved[k]) for k in range(9)]

        r_sq = residuals_sq(rot)
        # mu initialization on the first iteration (registration.cc:1628-1638).
        max_res = jnp.max(jnp.where(live_col, r_sq, -jnp.inf))
        mu_init = 1.0 / (2.0 * max_res / nbsq - 1.0)
        mu_new = jnp.where(i == 0, mu_init, mu)
        degenerate = (i == 0) & (mu_new <= 0.0)

        th1 = (mu_new + 1.0) / mu_new * nbsq
        th2 = mu_new / (mu_new + 1.0) * nbsq
        # Cost uses the PREVIOUS weights (registration.cc:1645-1648).
        new_cost = jnp.sum(w * r_sq * act)
        w_mid = jnp.sqrt(nbsq * mu_new * (mu_new + 1.0) / jnp.maximum(r_sq, 1e-30)) - mu_new
        w_new = jnp.where(
            r_sq >= th1, 0.0, jnp.where(r_sq <= th2, 1.0, jnp.clip(w_mid, 0.0, 1.0))
        ) * act
        converged = jnp.abs(new_cost - prev_cost) < cost_threshold
        # The degenerate break exits before updating weights/cost.
        return (
            i + 1,
            rot,
            jnp.where(degenerate, w, w_new),
            mu_new * gnc_factor,
            jnp.where(degenerate, prev_cost, new_cost),
            (degenerate | converged).astype(jnp.int32),
        )

    def cond(state):
        i, done = state[0], state[-1]
        return (i < max_iterations) & (done == 0)

    ident = [jnp.float32(1.0 if k % 4 == 0 else 0.0) for k in range(9)]
    init = (
        jnp.int32(0), ident, act, jnp.float32(1.0), jnp.float32(jnp.inf),
        jnp.int32(0),
    )
    _, r9, w, _, _, _ = jax.lax.while_loop(cond, body, init)
    rot = jnp.zeros((_NPAR,), jnp.float32)
    for k in range(9):
        rot = jnp.where(lane == k, r9[k], rot)
    rot_ref[...] = rot
    w_ref[...] = w


@functools.partial(
    jax.jit,
    static_argnames=("max_iterations", "gnc_factor", "cost_threshold", "interpret"),
)
def gnc_batch_pallas(
    src: jax.Array,  # (B, 3, Np)
    dst: jax.Array,  # (B, 3, Np)
    act: jax.Array,  # (B, Np) float {0, 1}
    par: jax.Array,  # (B, 16) per-hypothesis scalar row
    max_iterations: int = 100,
    gnc_factor: float = 1.4,
    cost_threshold: float = 0.005,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Returns (rotation rows (B, 16), first 9 row-major; weights (B, Np))."""
    b, npad = act.shape
    row = pl.BlockSpec((None, npad), lambda h: (h, 0))
    kernel = functools.partial(
        _kernel, max_iterations=max_iterations, gnc_factor=gnc_factor,
        cost_threshold=cost_threshold,
    )
    return pl.pallas_call(
        kernel,
        grid=(b,),
        in_specs=[row] * 7 + [pl.BlockSpec((None, _NPAR), lambda h: (h, 0))],
        out_specs=(
            pl.BlockSpec((None, _NPAR), lambda h: (h, 0)),
            row,
        ),
        out_shape=(
            jax.ShapeDtypeStruct((b, _NPAR), jnp.float32),
            jax.ShapeDtypeStruct((b, npad), jnp.float32),
        ),
        compiler_params=plt.CompilerParams(
            num_warps=max(1, min(8, npad // 256)), num_stages=1
        ),
        interpret=interpret,
        name="gnc_tls_batch",
    )(*src.transpose(1, 0, 2), *dst.transpose(1, 0, 2), act, par)


def gnc_batch(
    src_tims_b: jax.Array,  # (B, 3, N)
    dst_tims_b: jax.Array,  # (B, 3, N)
    active_b: jax.Array,  # (B, N) bool
    noise_bound_b: jax.Array,  # (B,)
    warm_rotation: jax.Array,  # (3, 3), shared warm start
    use_warm: jax.Array,  # () bool
    max_iterations: int,
    gnc_factor: float,
    cost_threshold: float,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Batch GNC-TLS front door. Returns (rotations (B, 3, 3),
    inliers (B, N) bool) with the reference's weight >= 0.5 rule and the
    <= 10-inlier fail-safe (registration.cc:1676-1691).

    `interpret=True` runs the kernel in the Pallas interpreter (tests on
    hosts without a card)."""
    b, _, n = src_tims_b.shape
    npad = padded_width(n)
    pad = ((0, 0), (0, 0), (0, npad - n))
    src = jnp.pad(src_tims_b.astype(jnp.float32), pad)
    dst = jnp.pad(dst_tims_b.astype(jnp.float32), pad)
    act = jnp.pad(active_b.astype(jnp.float32), ((0, 0), (0, npad - n)))
    nb_sq = jnp.square(noise_bound_b.astype(jnp.float32))
    nb_sq = jnp.where(nb_sq < 1e-16, 1e-2, nb_sq)
    par = jnp.concatenate(
        [
            nb_sq[:, None],
            jnp.broadcast_to(jnp.asarray(use_warm, jnp.float32), (b, 1)),
            jnp.broadcast_to(warm_rotation.astype(jnp.float32).reshape(1, 9), (b, 9)),
            jnp.zeros((b, _NPAR - 11), jnp.float32),
        ],
        axis=1,
    )
    rot16, w = gnc_batch_pallas(
        src, dst, act, par,
        max_iterations=max_iterations, gnc_factor=gnc_factor,
        cost_threshold=cost_threshold, interpret=interpret,
    )
    rotations = rot16[:, :9].reshape(b, 3, 3)
    inliers = (w[:, :n] >= 0.5) & active_b
    count = jnp.sum(inliers, axis=1, keepdims=True)
    inliers = jnp.where(count <= 10, active_b, inliers)
    return rotations, inliers
