"""Component-wise robust translation solver.

Equivalent of TLSTranslationSolver::solveForTranslation
(/root/reference/teaser/src/registration.cc:436-463): per-axis max-interval
stabbing on raw translations dst - src with noise beta = noise_bound *
sqrt(cbar2); a point is an inlier iff all three axes agree. The reference
cycles its STswitch global x -> y -> z and warm-starts each axis from
translation_last_best (registration.cc:137-161); here the warm start is an
explicit argument.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from psulvsb_tpu.robust.scalar_tls import max_stabbing
from psulvsb_tpu.utils.precision import mm


def solve_translation(
    src: jax.Array,
    dst: jax.Array,
    noise_bound: jax.Array | float,
    cbar2: jax.Array | float,
    active: jax.Array | None = None,
    warm_translation: jax.Array | None = None,
    use_warm: jax.Array | bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Returns (translation (3,), inlier mask over columns, translation_noise).

    src/dst: (3, N) point matrices (already rotated/scaled by the caller, as
    in registration.cc:1248).
    """
    if active is None:
        active = jnp.ones((src.shape[1],), dtype=bool)
    beta = jnp.asarray(noise_bound, src.dtype) * jnp.sqrt(jnp.asarray(cbar2, src.dtype))
    raw = dst - src  # (3, N)
    if warm_translation is None:
        warm_translation = jnp.zeros((3,), dtype=src.dtype)

    def solve_axis(row, warm):
        return max_stabbing(row, beta, active=active, warm_value=warm, use_warm=use_warm)

    est, inl = jax.vmap(solve_axis)(raw, warm_translation)
    inliers = jnp.all(inl, axis=0) & active
    return est, inliers, beta


def solve_translation_endpoints(
    src: jax.Array,
    dst: jax.Array,
    rotation: jax.Array,
    scale: jax.Array,
    b_i: jax.Array,
    b_j: jax.Array,
    tim_mask: jax.Array,
    noise_bound: jax.Array | float,
    cbar2: jax.Array | float,
    warm_translation: jax.Array | None = None,
    use_warm: jax.Array | bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Translation solve restricted to the (deduplicated) endpoints of the
    active basic TIMs — identical estimate to masking the full (3, C)
    arrays, at sort/cumsum sizes of 2L instead of C.

    The stabbing sweep is O(n log n) in the array size regardless of the
    active mask, and the point set fed to translation is by construction
    the TIM endpoints (registration.cc:1114-1154's `dub[]` dedup), at most
    2L points for L basic TIMs (sorts and cumsums sized 2L instead of C).
    Only the <= 2L candidate points are rotated (3 x 3 @ 3 x 2L instead of
    3 x C per hypothesis).

    Returns (translation_scaled (3,), point inliers (C,), points fed (C,),
    translation_noise). The caller divides by scale as usual
    (registration.cc:1248-1250).
    """
    c = src.shape[1]
    idx = jnp.concatenate([b_i, b_j])  # (2L,)
    okm = jnp.concatenate([tim_mask, tim_mask])
    # Dedup: sort by index (inactive slots to sentinel c), keep first of
    # each run — the compact active set equals endpoint_mask's point set.
    si = jnp.sort(jnp.where(okm, idx, c))
    first = (
        jnp.concatenate([jnp.ones((1,), bool), si[1:] != si[:-1]]) & (si < c)
    )
    gi = jnp.where(si < c, si, 0)
    moved = scale * mm(rotation, src[:, gi])
    t_s, inl, beta = solve_translation(
        moved,
        dst[:, gi],
        noise_bound,
        cbar2,
        active=first,
        warm_translation=warm_translation,
        use_warm=use_warm,
    )
    points_c = jnp.zeros((c,), bool).at[gi].max(first)
    inliers_c = jnp.zeros((c,), bool).at[gi].max(inl & first)
    return t_s, inliers_c, points_c, beta


def global_translation_vote(
    src: jax.Array,
    dst: jax.Array,
    rotation: jax.Array,
    scale: jax.Array,
    real: jax.Array,
    noise_bound: jax.Array | float,
    cbar2: jax.Array | float,
    current_translation: jax.Array,
    chunk: int = 512,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Joint 1-point translation consensus over ALL real correspondences.

    The per-axis stabbing above runs — as the reference does
    (registration.cc:1114-1154, 1248-1250) — over the ROTATION-INLIER
    subset only. Under repeated scene geometry that subset aliases: TIMs
    are translation-invariant, so matches landing on a translated copy of
    a repeated structure agree with the true inliers through the scale and
    rotation stages and split only at translation, where the subset can
    prefer the wrong copy (measured on the front-end protocol: 3/120 pairs
    whose solver pose carried LESS global support than the ground truth —
    docs/FRONTEND_FAILURES.md).

    This is the rescue: every correspondence proposes the translation it
    implies under the final rotation, t_i = (dst_i - s R src_i), and votes
    for every proposal within the per-axis noise box (the reference's
    translation-inlier criterion, AND over axes). The winning proposal's
    box members are averaged — a dense (chunk, C) compare/matmul sweep,
    no data-dependent shapes.

    Returns (t_new (3,) already divided by scale, support_new () int32,
    support_cur () int32 — the same box count at `current_translation`).
    The caller adopts t_new only if support strictly improves, so where
    the per-axis subset stab already found the global mode this is a
    no-op by construction.
    """
    c = src.shape[1]
    dtype = src.dtype
    beta = jnp.asarray(noise_bound, dtype) * jnp.sqrt(
        jnp.asarray(cbar2, dtype)
    )
    d = (dst - scale * mm(rotation, src)).T  # (C, 3) proposals, s-scaled
    w = real.astype(dtype)

    n_chunks = -(-c // chunk)
    pad = n_chunks * chunk - c
    dp = jnp.pad(d, ((0, pad), (0, 0)))

    def body(rows):  # (chunk, 3) -> (chunk,) vote counts
        within = jnp.all(
            jnp.abs(rows[:, None, :] - d[None, :, :]) <= beta, axis=-1
        )
        return mm(within.astype(dtype), w)

    votes = jax.lax.map(body, dp.reshape(n_chunks, chunk, 3)).reshape(-1)[:c]
    votes = jnp.where(real, votes, -jnp.ones_like(votes))
    i = jnp.argmax(votes)
    member = jnp.all(jnp.abs(d - d[i]) <= beta, axis=-1) & real
    denom = jnp.maximum(jnp.sum(member.astype(dtype)), jnp.asarray(1, dtype))
    center = jnp.sum(jnp.where(member[:, None], d, 0), axis=0) / denom
    s_safe = jnp.where(scale > 0, scale, jnp.ones_like(scale))
    cur_box = (
        jnp.all(jnp.abs(d - scale * current_translation) <= beta, axis=-1)
        & real
    )
    return (
        center / s_safe,
        jnp.sum(member, dtype=jnp.int32),
        jnp.sum(cur_box, dtype=jnp.int32),
    )


class TLSTranslationSolver:
    """Facade of teaser::TLSTranslationSolver (registration.h:194-217)."""

    def __init__(self, noise_bound: float, cbar2: float):
        self.noise_bound = noise_bound
        self.cbar2 = cbar2

    def solveForTranslation(self, src, dst):
        t, inliers, _ = solve_translation(
            jnp.asarray(src), jnp.asarray(dst), self.noise_bound, self.cbar2
        )
        return t, inliers
