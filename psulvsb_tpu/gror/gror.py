"""GROR — Graph Reliability Outlier Removal initial alignment, batched.

Equivalent of the vendored GRORInitialAlignment
(/root/reference/TEASER-plusplus/teaser/include/GROR/ia_gror.hpp:1-748,
used by registration_artificial.cc:571-576 with resolution = voxel size and
n_optimal = 800):

1. **Node reliability** (ia_gror.hpp:125-193): correspondence degree in the
   length-consistency graph (| |e_s| - |e_t| | < 2*resolution); keep the
   K_optimal most reliable. One dense (C, C) grid + top-k here.
2. **Edge reliability** (ia_gror.hpp:199-259): for candidate edges (pairs of
   correspondences), align the two pairs exactly (direction-aligning
   rotation + mean translation, ia_gror.hpp:418-441), count support in the
   relaxed constraint space (RCFS: length + axial-projection consistency,
   ia_gror.hpp:474-521), then resolve the remaining rotation freedom about
   the edge axis by 1-D angular interval stabbing (TCFS,
   ia_gror.hpp:619-748: cylindrical-coordinate feasibility circles ->
   azimuth intervals -> max stabbing). The reference walks edges serially
   with best-count pruning; here every candidate edge is evaluated in one
   vmap and the argmax wins.
3. **Refinement** (ia_gror.hpp:259-379): inliers = correspondences within
   2*resolution under the best transform; Umeyama/Kabsch fit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.core.linalg import weighted_procrustes_srt
from psulvsb_tpu.ops.pair_grid import consistency_degree
from psulvsb_tpu.utils.precision import mm

_TWOPI = 2.0 * np.pi
_EPS = 1e-7


class GRORResult(NamedTuple):
    rotation: jax.Array  # (3, 3)
    translation: jax.Array  # (3,)
    best_count: jax.Array  # () int32 — TCFS consensus of the winning edge
    inliers: jax.Array  # (C,) bool over input correspondences


def _two_vectors_align(a: jax.Array, b: jax.Array) -> jax.Array:
    """Rotation taking unit vector a to unit vector b (ia_gror.hpp:443-458),
    guarded against the antiparallel singularity (c -> -1) by falling back
    to a 180-degree flip about any orthogonal axis."""
    v = jnp.cross(a, b)
    c = jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)
    vx = jnp.array(
        [
            [0.0, -v[2], v[1]],
            [v[2], 0.0, -v[0]],
            [-v[1], v[0], 0.0],
        ],
        dtype=a.dtype,
    )
    r = jnp.eye(3, dtype=a.dtype) + vx + mm(vx, vx) * (1.0 / jnp.maximum(1.0 + c, 1e-6))
    # Antiparallel fallback: rotate pi about an axis orthogonal to a.
    ortho = jnp.where(
        jnp.abs(a[0]) < 0.9,
        jnp.array([1.0, 0.0, 0.0], a.dtype),
        jnp.array([0.0, 1.0, 0.0], a.dtype),
    )
    axis = jnp.cross(a, ortho)
    axis = axis / jnp.maximum(jnp.linalg.norm(axis), 1e-20)
    flip = 2.0 * jnp.outer(axis, axis) - jnp.eye(3, dtype=a.dtype)
    return jnp.where(c < -0.999, flip, r)


def _axis_angle_rotation(axis: jax.Array, angle: jax.Array) -> jax.Array:
    axis = axis / jnp.maximum(jnp.linalg.norm(axis), 1e-20)
    vx = jnp.array(
        [
            [0.0, -axis[2], axis[1]],
            [axis[2], 0.0, -axis[0]],
            [-axis[1], axis[0], 0.0],
        ],
        dtype=axis.dtype,
    )
    return (
        jnp.eye(3, dtype=axis.dtype)
        + jnp.sin(angle) * vx
        + (1.0 - jnp.cos(angle)) * mm(vx, vx)
    )


def _interval_stab_one_to_one(
    beg: jax.Array, end: jax.Array, valid: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Max stabbing over [begin, end] angle intervals (the one_to_one branch
    of intervalStab, ia_gror.hpp:592-616): count = #starts <= x minus
    #ends < x, maximized over start locations."""
    big = jnp.asarray(1e9, beg.dtype)
    starts = jnp.where(valid, beg, big)
    ends = jnp.where(valid, end, big)
    locs = jnp.concatenate([starts, ends])
    deltas = jnp.concatenate(
        [jnp.where(valid, 1.0, 0.0), jnp.where(valid, -1.0, 0.0)]
    ).astype(beg.dtype)
    order = jnp.lexsort((-deltas, locs))  # starts before ends on ties
    d_s = deltas[order]
    l_s = locs[order]
    cnt = jnp.cumsum(d_s)
    score = jnp.where(d_s > 0, cnt, -1.0)
    best = jnp.argmax(score)
    return l_s[best], score[best].astype(jnp.int32)


def _evaluate_edge(
    e_i: jax.Array,
    e_j: jax.Array,
    src_k: jax.Array,
    dst_k: jax.Array,
    corr_active: jax.Array,
    resolution: float,
):
    """One candidate edge: two-pair align + RCFS + TCFS. All inputs are the
    K-selected correspondence points (3, K)."""
    dtype = src_k.dtype
    thr = 2.0 * resolution

    s1, t1 = src_k[:, e_i], dst_k[:, e_i]
    s2, t2 = src_k[:, e_j], dst_k[:, e_j]

    vec_s = s1 - s2
    vec_t = t1 - t2
    vec_s = vec_s / jnp.maximum(jnp.linalg.norm(vec_s), 1e-20)
    axis_t = vec_t / jnp.maximum(jnp.linalg.norm(vec_t), 1e-20)

    r0 = _two_vectors_align(vec_s, axis_t)
    t0 = 0.5 * ((t1 - mm(r0, s1)) + (t2 - mm(r0, s2)))
    origin = t1

    # --- RCFS (ia_gror.hpp:474-521) ----------------------------------------
    diff_s = src_k - s1[:, None]
    diff_t = dst_k - t1[:, None]
    dist_s = jnp.linalg.norm(diff_s, axis=0)
    dist_t = jnp.linalg.norm(diff_t, axis=0)
    axis_s = mm(r0.T, axis_t)
    proj = jnp.abs(
        jnp.sum(diff_t * axis_t[:, None], axis=0)
        - jnp.sum(diff_s * axis_s[:, None], axis=0)
    )
    rcfs = (jnp.abs(dist_t - dist_s) < thr) & (proj < thr) & corr_active
    rcfs_count = jnp.sum(rcfs, dtype=jnp.int32)

    # --- TCFS (ia_gror.hpp:619-748) -----------------------------------------
    # Local frame: origin -> 0, axis -> z; source additionally pre-moved by
    # the two-pair transform.
    r_loc = _two_vectors_align(axis_t, jnp.array([0.0, 0.0, 1.0], dtype))
    t_loc = dst_k - origin[:, None]
    s_loc = mm(r_loc, mm(r0, src_k) + t0[:, None] - origin[:, None])
    t_loc = mm(r_loc, t_loc)

    m_len = jnp.sqrt(s_loc[0] ** 2 + s_loc[1] ** 2)
    b_len = jnp.sqrt(t_loc[0] ** 2 + t_loc[1] ** 2)
    m_azi = jnp.arctan2(s_loc[1], s_loc[0])
    b_azi = jnp.arctan2(t_loc[1], t_loc[0])
    dz = t_loc[2] - s_loc[2]
    d_len = b_len - m_len

    th_mz = thr * thr - dz * dz
    feasible = (d_len * d_len <= th_mz) & corr_active & (th_mz > 0)
    rth = jnp.sqrt(jnp.maximum(th_mz, 0.0))

    # circleIntersection(R = m_len, d = b_len, r = rth) (ia_gror.hpp:538-571).
    x = (b_len * b_len - rth * rth + m_len * m_len) / jnp.maximum(2.0 * b_len, 1e-20)
    rat = x / jnp.maximum(m_len, 1e-20)
    dev = jnp.where(
        (b_len <= _EPS) | (rat <= -1.0), jnp.pi, jnp.arccos(jnp.clip(rat, -1.0, 1.0))
    )
    full = (m_len <= _EPS) | (jnp.abs(dev - jnp.pi) <= _EPS)

    beg = jnp.mod(b_azi - dev - m_azi, _TWOPI)
    end = jnp.mod(b_azi + dev - m_azi, _TWOPI)
    # Wrap-around split: [beg, 2pi] + [0, end] when end < beg; full circle
    # becomes [0, 2pi]. Two static interval slots per correspondence.
    wrap = (end < beg) & ~full
    beg1 = jnp.where(full, 0.0, beg)
    end1 = jnp.where(full, _TWOPI, jnp.where(wrap, _TWOPI, end))
    beg2 = jnp.zeros_like(beg)
    end2 = jnp.where(wrap, end, 0.0)
    v1 = feasible
    v2 = feasible & wrap

    angle, tcfs_count = _interval_stab_one_to_one(
        jnp.concatenate([beg1, beg2]),
        jnp.concatenate([end1, end2]),
        jnp.concatenate([v1, v2]),
    )
    return rcfs_count, tcfs_count, angle, r0, t0, axis_t, origin


@functools.partial(
    jax.jit, static_argnames=("resolution", "k_optimal", "min_edge_support")
)
def _gror_core(
    src: jax.Array,
    dst: jax.Array,
    corr_active: jax.Array,
    resolution: float,
    k_optimal: int,
    min_edge_support: int = 10,
):
    c = src.shape[1]
    dtype = src.dtype
    thr = 2.0 * resolution

    # --- node reliability + top-K selection ---------------------------------
    # Degrees over the full pair grid (ops/pair_grid.py: one fused
    # elementwise pass and row sum, direct differences).
    degree = consistency_degree(src, dst, thr, active=corr_active)

    k = min(k_optimal, c)
    deg_masked = jnp.where(corr_active, degree, -1)
    _, top = jax.lax.top_k(deg_masked, k)
    sel_active = deg_masked[top] >= 0

    src_k = src[:, top]
    dst_k = dst[:, top]
    ds_k = jnp.linalg.norm(src_k[:, :, None] - src_k[:, None, :], axis=0)
    dt_k = jnp.linalg.norm(dst_k[:, :, None] - dst_k[:, None, :], axis=0)
    cons_k = (jnp.abs(ds_k - dt_k) < thr) & sel_active[:, None] & sel_active[None, :]
    cons_k = cons_k & ~jnp.eye(k, dtype=bool)

    # --- candidate edges -----------------------------------------------------
    # The reference evaluates, per selected node, its first consistent
    # partner, visiting nodes in edge-count order with pruning
    # (ia_gror.hpp:199-259). Batched: every selected node contributes the
    # candidate edge (node, argmax-degree consistent partner); all evaluated
    # at once, argmax TCFS count wins.
    deg_k = jnp.sum(cons_k, axis=1)
    partner_score = jnp.where(cons_k, deg_k[None, :], -1)
    partner = jnp.argmax(partner_score, axis=1)
    has_partner = jnp.max(partner_score, axis=1) >= 0
    edge_ok = sel_active & has_partner & (deg_k >= min_edge_support)

    e_i = jnp.arange(k)
    rcfs, tcfs, angles, r0s, t0s, axes, origins = jax.vmap(
        lambda i, j: _evaluate_edge(i, j, src_k, dst_k, sel_active, resolution)
    )(e_i, partner)
    tcfs = jnp.where(edge_ok, tcfs, -1)
    best = jnp.argmax(tcfs)

    # --- compose final transform (ia_gror.hpp:405-414) ----------------------
    r0 = r0s[best]
    t0 = t0s[best]
    rot = _axis_angle_rotation(axes[best], angles[best])
    origin = origins[best]
    # T = T(origin) * R(angle) * T(-origin) * [r0 | t0]
    r_final = mm(rot, r0)
    t_final = mm(rot, t0 - origin) + origin

    # --- inlier extraction + Kabsch refinement (ia_gror.hpp:259-379) --------
    moved = mm(r_final, src) + t_final[:, None]
    dist = jnp.linalg.norm(moved - dst, axis=0)
    inliers = (dist < thr) & corr_active
    w = inliers.astype(dtype)
    r_ref, t_ref = weighted_procrustes_srt(src, dst, w)
    ok = jnp.sum(w) >= 3
    r_out = jnp.where(ok, r_ref, r_final)
    t_out = jnp.where(ok, t_ref, t_final)
    return GRORResult(
        rotation=r_out,
        translation=t_out,
        best_count=tcfs[best],
        inliers=inliers,
    )


def gror_align(
    src,
    dst,
    resolution: float,
    k_optimal: int = 800,
    corr_active=None,
) -> GRORResult:
    """GROR initial alignment of matched correspondences.

    src/dst: (3, C) matched points (the reference's correspondence indices
    resolved into point pairs). resolution: cloud resolution (the voxel
    leaf); all consistency thresholds are 2*resolution. k_optimal: node
    count kept by reliability selection (registration_artificial.cc:536
    uses 800).
    """
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    if corr_active is None:
        corr_active = jnp.ones((src.shape[1],), bool)
    return _gror_core(src, dst, corr_active, float(resolution), int(k_optimal))


class GRORInitialAlignment:
    """Class facade mirroring pcl::registration::GRORInitialAlignment
    (ia_gror.h:26-260) at the setter-API level."""

    def __init__(self):
        self._source = None
        self._target = None
        self._corr = None
        self.resolution = 0.1
        self.k_optimal = 800

    def setInputSource(self, pts):
        self._source = np.asarray(pts)

    def setInputTarget(self, pts):
        self._target = np.asarray(pts)

    def setResolution(self, r: float):
        self.resolution = float(r)

    def setOptimalSelectionNumber(self, k: int):
        self.k_optimal = int(k)

    def setNumberOfThreads(self, n: int):
        pass  # parallelism is the vmap width on the device

    def setInputCorrespondences(self, corr):
        self._corr = np.asarray(corr, np.int64)

    def align(self) -> GRORResult:
        src = self._source[:, self._corr[:, 0]]
        dst = self._target[:, self._corr[:, 1]]
        return gror_align(src, dst, self.resolution, self.k_optimal)
