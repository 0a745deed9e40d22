"""PSULVSB two-level probabilistic RANSAC orchestration — batched.

Re-design of RobustRegistrationSolver::solve(src, dst)
(/root/reference/teaser/src/registration.cc:622-1535). The reference is a
serial CPU program: one hypothesis (basic iteration) at a time, dynamic
Eigen resizes, warm-start state in file-scope globals, confidence-driven
while loops. The batched form inverts it:

- **Batched hypotheses**: each local-loop step evaluates a vmapped batch of
  `hypothesis_batch` independent basic sets (scale -> GNC rotation ->
  translation -> sampled-point scoring); the serial confidence-stopping /
  acceptance rules are replayed over the batch in order, so the probability
  accounting (pro_local = 1 - (1 - w)^local_r, registration.cc:1352) is
  preserved while the arithmetic runs wide.
- **Static shapes + masks**: the correspondence set never grows
  (conservativeResize at registration.cc:795-827); instead (C,)-masks over
  the padded original set flip on (self-update), and the reduced
  line-vector set lives as a compacted (i, j) pair-index array of static
  capacity — built either from one exact O(C^2) sweep or by rejection
  sampling (init_mode), never carried as an O(C^2) mask.
- **Explicit carries**: the reference's globals (registration.cc:40-50)
  become `WarmState` + `HostState` pytrees threaded through `lax.while_loop`
  and the host-round Python loop (host rounds are the natural wall-clock
  check boundary, matching the 60 s budget check at registration.cc:1475).

Known, intentional divergences from the reference (documented per
SURVEY.md §7 "hard parts"):
- RNG is jax.random (seeded, reproducible); the reference uses
  rand()/time(NULL) and is not reproducible even against itself.
- Within one hypothesis batch, all hypotheses share the warm state of the
  batch start (the serial loop would update it between consecutive
  hypotheses). Batch width 1 reproduces the serial schedule.
- Sampled/basic sets are capped at `sampled_cap`/`basic_cap` — the
  escalation ladder still reaches rate 1.0 but set sizes saturate at the
  caps (the reference's sets are unbounded; the caps are far above the
  inlier counts that matter for GNC).
- The reference's self-update re-admission branch contains assignment-
  in-condition bugs (`inlier_history[j] = 0 ||`, registration.cc:1438);
  the published intent (probabilistic demotion of previously-inlier
  points) is implemented instead.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.core.linalg import weighted_procrustes_srt
from psulvsb_tpu.utils.precision import mm
from psulvsb_tpu.core.metrics import angular_error_rad, masked_rmse, inlier_probability
from psulvsb_tpu.pairs.tims import (
    triu_pair_indices,
    ratio_bin_indices,
    sort_peak_bin,
    masked_random_compact,
)
from psulvsb_tpu.robust.scale import select_scale_inliers, solve_scale_tls
from psulvsb_tpu.robust.translation import (
    global_translation_vote,
    solve_translation,
    solve_translation_endpoints,
)
from psulvsb_tpu.clique.kcore import greedy_clique, triangle_scores
from psulvsb_tpu.ops.pair_grid import (
    bin_counts,
    pair_beta_count,
    pair_lengths,
    pair_ratio_histogram,
    peak_window_count,
    ratio_bins,
)
from psulvsb_tpu.solver.basic import (
    WarmState,
    basic_step,
    endpoint_mask,
    score_transform,
)
from psulvsb_tpu.solver.config import (
    SolverParams,
    RATE_SCHEDULE,
    InlierSelectionMode,
    RotationEstimationAlgorithm,
)
from psulvsb_tpu.solver.solution import RegistrationSolution


# =============================================================================
# Stage 1: line-vector universe + initial reduced set
# =============================================================================


def _num_bins(params: SolverParams) -> int:
    """Bins of the full-range ratio histogram (registration.cc:687-688)."""
    return int(params.hist_max_scale) * params.hist_bins_per_unit


def _pair_window_test(
    ori_src, ori_dst, pi, pj, params: SolverParams, peak_bin
):
    """Membership test for the reduced set at explicit pairs (pi, pj):
    histogram peak +-1 bins (estimate_scaling) or the known-scale beta test
    (registration.cc:744-767)."""
    st = ori_src[:, pj] - ori_src[:, pi]
    dt = ori_dst[:, pj] - ori_dst[:, pi]
    v1 = jnp.sqrt(jnp.sum(st * st, axis=0))
    v2 = jnp.sqrt(jnp.sum(dt * dt, axis=0))
    if params.estimate_scaling:
        num_bins = _num_bins(params)
        ratios = v2 / jnp.where(v1 > 0, v1, 1.0)
        b = jnp.clip(
            jnp.floor(ratios / params.hist_max_scale * num_bins).astype(jnp.int32),
            0,
            num_bins - 1,
        )
        return jnp.abs(b - peak_bin) <= 1
    beta = 2.0 * params.noise_bound * np.sqrt(params.cbar2)
    return jnp.abs(v1 - v2) <= beta


def _pool_caps(params: SolverParams) -> tuple[int, int]:
    """(pool slot capacity, init fill target) for the materialized reduced
    pool. Fill stays below capacity so self-update appends always have
    reserve slots (config.pool_cap / pool_reserve)."""
    pool = min(params.pool_cap, params.reduced_cap)
    fill = pool - min(params.pool_reserve, pool // 8)
    return pool, fill


def _pad_pool(red_i: jax.Array, red_j: jax.Array, pool: int):
    """Zero-pad compacted index arrays from fill size up to pool capacity
    (padding slots are never valid — consumers gate on slot < pool_count —
    but must hold safe gather indices)."""
    extra = pool - red_i.shape[0]
    if extra <= 0:
        return red_i, red_j
    return (
        jnp.pad(red_i, (0, extra)),
        jnp.pad(red_j, (0, extra)),
    )


def _init_stage_sampled(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    keep_mask: jax.Array,
    params: SolverParams,
    key: jax.Array,
):
    """Large-C init: never materializes the O(C^2) universe.

    1. Locate the histogram peak bin from `init_peak_sample` uniform random
       active pairs (the mode is identifiable from a subsample; the solver
       only needs peak +-1 membership, registration.cc:744-752).
    2. Rejection-sample the reduced set: draw `init_reject_budget` random
       pairs, keep those passing the window test — exactly uniform over the
       reduced set, and the loop only ever consumes sampled_cap TIMs per
       round. red_count is estimated as L * acceptance_rate (it only feeds
       the floor(|reduced| * rate) sample-size rule).

    Divergences vs the exact sweep: pair draws are with replacement
    (duplicate TIMs possible at ~0.1% rates) and red_count is an estimate.
    """
    c = ori_src.shape[1]
    n_l = c * (c - 1) // 2
    active = keep_mask == 1
    k1, k2 = jax.random.split(key)

    peak_bin = jnp.int32(0)
    if params.estimate_scaling:
        peak_bin = _subsample_peak(ori_src, ori_dst, active, params, k1)
    return _fill_reduced_pool(
        ori_src, ori_dst, active, peak_bin, n_l, params, k2
    )


def _draw_pairs(key, budget: int, c: int):
    """budget uniform random unordered pairs (i < j, i != j) over [0, c)."""
    ka, kb = jax.random.split(key)
    a = jax.random.randint(ka, (budget,), 0, c)
    b = jax.random.randint(kb, (budget,), 0, c - 1)
    b = jnp.where(b >= a, b + 1, b)  # b != a, uniform over pairs
    return jnp.minimum(a, b), jnp.maximum(a, b)


def _subsample_peak(ori_src, ori_dst, active, params: SolverParams, key):
    """Histogram peak-bin estimate from `init_peak_sample` uniform random
    active pairs (the scale mode is identifiable from a subsample)."""
    c = ori_src.shape[1]
    pi, pj = _draw_pairs(key, params.init_peak_sample, c)
    ok = active[pi] & active[pj]
    st = ori_src[:, pj] - ori_src[:, pi]
    dt = ori_dst[:, pj] - ori_dst[:, pi]
    v1 = jnp.sqrt(jnp.sum(st * st, axis=0))
    v2 = jnp.sqrt(jnp.sum(dt * dt, axis=0))
    bin_idx, num_bins = ratio_bin_indices(
        v2 / jnp.where(v1 > 0, v1, 1.0),
        max_scale=params.hist_max_scale,
        bins_per_unit=params.hist_bins_per_unit,
    )
    peak_bin, _ = sort_peak_bin(bin_idx, ok, num_bins)
    return peak_bin


def _fill_reduced_pool(
    ori_src, ori_dst, active, peak_bin, n_l, params: SolverParams, key
):
    """Rejection-fill of the reduced pool against a known peak bin: draw
    init_reject_budget random pairs, keep window-test passers (uniform over
    the reduced set), compact scatter-free."""
    c = ori_src.shape[1]
    pool_cap, fill_cap = _pool_caps(params)
    budget = params.init_reject_budget
    k_draw, k_compact = jax.random.split(key)
    pi, pj = _draw_pairs(k_draw, budget, c)
    member = (
        active[pi] & active[pj] & _pair_window_test(
            ori_src, ori_dst, pi, pj, params, peak_bin
        )
    )
    accept = jnp.sum(member, dtype=jnp.int32)
    red_count_est = jnp.minimum(
        (accept.astype(jnp.float32) / budget * n_l).astype(jnp.int32),
        params.reduced_cap,
    )
    # The pool holds min(accept, fill_cap) actual members; red_count (the
    # |reduced| size estimate) may exceed the pool — sampling clamps to the
    # pool size.
    red_i, red_j, pool = masked_random_compact(
        k_compact, member, pi, pj, fill_cap, max_index=c
    )
    red_i, red_j = _pad_pool(red_i, red_j, pool_cap)
    return red_i, red_j, red_count_est, pool


def _init_stage_exact_hist(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    keep_mask: jax.Array,
    params: SolverParams,
    key: jax.Array,
):
    """Large-C scale-estimation init with the EXACT histogram peak: a
    row-blocked sweep of all C(C-1)/2 ratios over the full
    hist_max_scale * hist_bins_per_unit bin range (ops/pair_grid.py), with
    O(block * C) memory. It yields the exact peak bin and the exact
    reduced-set size |peak +- 1|, where the "sampled" mode only estimates
    both from a pair subsample; the pool is rejection-sampled against the
    exact peak."""
    c = ori_src.shape[1]
    n_l = c * (c - 1) // 2
    active = keep_mask == 1
    counts = pair_ratio_histogram(
        ori_src, ori_dst, active,
        bins_per_unit=params.hist_bins_per_unit, num_bins=_num_bins(params),
    )
    peak = jnp.argmax(counts).astype(jnp.int32)
    _, k_fill = jax.random.split(key)
    red_i, red_j, _red_est, pool = _fill_reduced_pool(
        ori_src, ori_dst, active, peak, n_l, params, k_fill
    )
    red_count = jnp.minimum(peak_window_count(counts, peak), params.reduced_cap)
    return red_i, red_j, red_count, pool


def _init_stage_exact_beta(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    keep_mask: jax.Array,
    params: SolverParams,
    key: jax.Array,
):
    """Large-C KNOWN-SCALE init with the EXACT reduced-set size: a
    row-blocked sweep of all C(C-1)/2 pairs' beta-window tests
    (ops/pair_grid.py::pair_beta_count), so red_count (which drives the
    floor(|reduced| * rate) sample-size rule) is exact. The membership test
    itself is exact per pair (registration.cc:753-767); the pool is
    rejection-sampled (uniform over the reduced set) as in the sampled
    mode."""
    c = ori_src.shape[1]
    n_l = c * (c - 1) // 2
    active = keep_mask == 1
    beta = 2.0 * params.noise_bound * np.sqrt(params.cbar2)
    red_exact = pair_beta_count(ori_src, ori_dst, beta, active)
    _, k_fill = jax.random.split(key)
    red_i, red_j, _red_est, pool = _fill_reduced_pool(
        ori_src, ori_dst, active, jnp.int32(0), n_l, params, k_fill
    )
    red_count = jnp.minimum(red_exact, params.reduced_cap)
    return red_i, red_j, red_count, pool


def _init_stage_dense(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    keep_mask: jax.Array,
    params: SolverParams,
    key: jax.Array,
):
    """Exact reduced set over the dense (C, C) pair grid — the path for
    C <= dense_init_max_c.

    The gather-based exact sweep (the `triu_pair_indices` branch of
    _init_stage) moves O(C^2) TIM columns through random-access gathers;
    here the pair lengths come from one fused elementwise pass over the
    (C, C) grid (ops/pair_grid.pair_lengths, direct differences) and
    membership is an elementwise window over it. Under estimate_scaling the
    peak is the argmax of the exact full-range histogram of the same grid
    (one scatter-add). Compaction is a hashed priority + `approx_max_k`:
    the hash tie-breaks uniformly, so an over-cap reduced set is thinned
    uniformly exactly as masked_random_compact does. approx_max_k's recall
    target (0.95) can drop a few members when the reduced set is below the
    cap — a uniform random thinning, absorbed by the same red_count/pool
    contract as the sampled mode. Reference semantics:
    registration.cc:744-767.
    """
    c = ori_src.shape[1]
    pool_cap, fill_cap = _pool_caps(params)
    active = keep_mask == 1

    s = ori_src.astype(jnp.float32)
    d = ori_dst.astype(jnp.float32)
    v1, v2 = pair_lengths(s, d, s, d)
    iu = jnp.arange(c)
    valid = (iu[:, None] < iu[None, :]) & active[:, None] & active[None, :]

    if params.estimate_scaling:
        num_bins = _num_bins(params)
        bins = ratio_bins(v1, v2, params.hist_bins_per_unit, num_bins)
        counts = bin_counts(bins, valid, jnp.zeros((num_bins,), jnp.int32))
        peak = jnp.argmax(counts).astype(jnp.int32)
        member = (jnp.abs(bins - peak) <= 1) & valid
    else:
        beta = 2.0 * params.noise_bound * np.sqrt(params.cbar2)
        member = (jnp.abs(v1 - v2) <= beta) & valid

    red_count = jnp.minimum(jnp.sum(member, dtype=jnp.int32), params.reduced_cap)

    # Multiplicative-xorshift hash of the flat pair position as the random
    # priority (threefry over 25M lanes would dominate the stage).
    _, k_hash = jax.random.split(key)
    ab = jax.random.randint(k_hash, (2,), 1, jnp.iinfo(jnp.int32).max)
    pos = (
        jnp.arange(c, dtype=jnp.uint32)[:, None] * jnp.uint32(c)
        + jnp.arange(c, dtype=jnp.uint32)[None, :]
    )
    h = pos * (ab[0].astype(jnp.uint32) | jnp.uint32(1)) + ab[1].astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x45D9F3B)
    h = h ^ (h >> 16)
    pri = jnp.where(member, h.astype(jnp.float32), -1.0).reshape(-1)
    k = min(fill_cap, c * c)  # approx_max_k needs k <= input size (small C)
    vals, idx = jax.lax.approx_max_k(pri, k)
    if k < pool_cap:
        vals = jnp.pad(vals, (0, pool_cap - k), constant_values=-1.0)
        idx = jnp.pad(idx, (0, pool_cap - k))
    ok = vals >= 0.0
    idx = idx.astype(jnp.uint32)
    red_i = jnp.where(ok, (idx // c).astype(jnp.int32), 0)
    red_j = jnp.where(ok, (idx % c).astype(jnp.int32), 0)
    pool = jnp.sum(ok, dtype=jnp.int32)
    return red_i, red_j, red_count, pool


def resolve_init_mode(params: SolverParams, c: int) -> str:
    """The init mode "auto" selects for C correspondences: the dense grid
    up to dense_init_max_c, then the row-blocked exact sweeps (exact peak
    under scale estimation, exact |reduced| at known scale), each with a
    rejection-sampled pool."""
    if c <= params.dense_init_max_c:
        return "dense"
    return "exact_hist" if params.estimate_scaling else "exact_beta"


@functools.partial(jax.jit, static_argnames=("params",))
def _init_stage(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    keep_mask: jax.Array,
    params: SolverParams,
    key: jax.Array,
):
    """Build the TIM universe over the original correspondence set, the
    initial reduced line-vector set (registration.cc:682-767), and compact
    it into an explicit (i, j) pair-index array.

    Modes (params.init_mode): "exact" sweeps the O(C^2) universe once;
    "auto" routes by size alone: "dense" up to dense_init_max_c, then
    "exact_hist" (scale estimation) or "exact_beta" (known scale) — no
    O(C^2) materialization beyond the dense window.

    keep_mask: (C,) int32 in {1, 0, -1} as produced by the histogram
    pre-filter (PSULVSB.cc:87-172): 1 = reduced set, 0 = dropped but
    re-admittable, -1 = discarded.

    Returns (red_i (R,), red_j (R,), red_count (), pool_count ()).
    """
    c = ori_src.shape[1]
    n_l = c * (c - 1) // 2
    mode = params.init_mode
    if mode == "auto":
        mode = resolve_init_mode(params, c)
    if mode == "exact_hist" and not params.estimate_scaling:
        mode = "sampled"  # no histogram in the known-scale branch
    if mode == "exact_beta" and params.estimate_scaling:
        mode = "sampled"  # the beta window is the known-scale test
    if mode == "sampled":
        return _init_stage_sampled(ori_src, ori_dst, keep_mask, params, key)
    if mode == "exact_hist":
        return _init_stage_exact_hist(ori_src, ori_dst, keep_mask, params, key)
    if mode == "exact_beta":
        return _init_stage_exact_beta(ori_src, ori_dst, keep_mask, params, key)
    if mode == "dense":
        return _init_stage_dense(ori_src, ori_dst, keep_mask, params, key)
    ii_np, jj_np = triu_pair_indices(c)
    idx_i, idx_j = jnp.asarray(ii_np), jnp.asarray(jj_np)

    active = keep_mask == 1
    pair_active = active[idx_i] & active[idx_j]

    src_tims = ori_src[:, idx_j] - ori_src[:, idx_i]
    dst_tims = ori_dst[:, idx_j] - ori_dst[:, idx_i]

    if params.estimate_scaling:
        v1 = jnp.sqrt(jnp.sum(src_tims * src_tims, axis=0))
        v2 = jnp.sqrt(jnp.sum(dst_tims * dst_tims, axis=0))
        ratios = v2 / jnp.where(v1 > 0, v1, 1.0)
        # Peak: sort the bin indices and take the longest run
        # (pairs/tims.py::sort_peak_bin).
        bin_idx, num_bins = ratio_bin_indices(
            ratios,
            max_scale=params.hist_max_scale,
            bins_per_unit=params.hist_bins_per_unit,
        )
        peak, _cnt = sort_peak_bin(bin_idx, pair_active, num_bins)
        reduced_mask = (jnp.abs(bin_idx - peak) <= 1) & pair_active
        # Outer scale estimate comes later per basic iteration; the outer
        # solveForScale is skipped in the estimate_scaling branch
        # (registration.cc:744-752): reduction is purely histogram-based.
    else:
        # Known scale: reduced set = scale-consistency inliers over ALL TIMs
        # with the USER noise bound (registration.cc:753-767).
        _, inliers, _ = select_scale_inliers(
            src_tims, dst_tims, params.noise_bound, params.cbar2, active=pair_active
        )
        reduced_mask = inliers

    # Scatter-free compaction; the random sort keys double as the uniform
    # decimation when the reduced set overflows the pool (plain cumsum
    # compaction would keep lexicographically-first pairs — biased low-i).
    pool_cap, fill_cap = _pool_caps(params)
    red_count = jnp.minimum(
        jnp.sum(reduced_mask, dtype=jnp.int32), params.reduced_cap
    )
    red_i, red_j, pool = masked_random_compact(
        key, reduced_mask, idx_i, idx_j, fill_cap, max_index=c
    )
    red_i, red_j = _pad_pool(red_i, red_j, pool_cap)
    return red_i, red_j, red_count, pool


# =============================================================================
# Stage 1b (optional): clique-seeded warm start
# =============================================================================


@functools.partial(jax.jit, static_argnames=("params",))
def dense_consistency_adjacency(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    red_i: jax.Array,
    red_j: jax.Array,
    red_pool: jax.Array,
    params: SolverParams,
    active: jax.Array,
) -> jax.Array:
    """The exact (C, C) consistency graph the clique seed uses
    (registration.cc:744-767's membership tests over the dense pair grid).

    Known scale: beta window |d_dst - d_src| <= 2 nb sqrt(cbar2). Scale
    estimation: ratio-histogram window (|bin - peak| <= 1, the reduced-set
    membership test) with the peak taken as the median bin of the pool
    members (red_i/red_j/red_pool — peak +-1 members by construction;
    red_pool == 0 leaves a garbage peak, an empty clique, and ok=False
    downstream). Shared by _clique_seed_stage and the clique-at-scale
    audit (tools/clique_scale_audit.py) so the audited graphs ARE the
    solver's graphs."""
    c = ori_src.shape[1]
    s = ori_src.astype(jnp.float32)
    d = ori_dst.astype(jnp.float32)
    v1, v2 = pair_lengths(s, d, s, d)
    if params.estimate_scaling:
        num_bins = _num_bins(params)
        bins = ratio_bins(v1, v2, params.hist_bins_per_unit, num_bins)
        st = ori_src[:, red_j] - ori_src[:, red_i]
        dt = ori_dst[:, red_j] - ori_dst[:, red_i]
        p1 = jnp.sqrt(jnp.sum(st * st, axis=0))
        p2 = jnp.sqrt(jnp.sum(dt * dt, axis=0))
        pb = ratio_bins(p1, p2, params.hist_bins_per_unit, num_bins)
        slot_ok = jnp.arange(red_i.shape[0]) < red_pool
        pb_sorted = jnp.sort(jnp.where(slot_ok, pb, jnp.int32(1 << 30)))
        peak = pb_sorted[jnp.maximum(red_pool // 2 - 1, 0)]
        member = jnp.abs(bins - peak) <= 1
    else:
        beta = 2.0 * params.noise_bound * np.sqrt(params.cbar2)
        member = jnp.abs(v1 - v2) <= beta
    iu = jnp.arange(c)
    return (
        member
        & (iu[:, None] != iu[None, :])
        & active[:, None]
        & active[None, :]
    )


def _clique_seed_stage(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    red_i: jax.Array,
    red_j: jax.Array,
    red_pool: jax.Array,
    params: SolverParams,
    key: jax.Array,
    active: jax.Array | None = None,
):
    """Greedy clique over the reduced-set consistency graph + one chain-TIM
    decoupled solve over the clique points, producing a WarmState seed
    (params.clique_init; see config.py for the rationale).

    Documented divergence from the reference: no such stage exists there —
    at known scale rotation consumes all basic TIMs (registration.cc:984-991)
    and the clique (registration.cc:1000-1056) feeds only the translation
    point set. This stage reuses the clique idea upstream TEASER applies
    (clique -> chain TIMs -> rotation, the solver/classic.py order) on the
    already-compacted reduced set, so it costs one (C, C) adjacency scatter
    and a ~clique_cap-sized decoupled solve per run.

    When `active` (the current correspondence mask over points) is given
    and C fits the dense window, the consistency graph is rebuilt EXACTLY
    over the (C, C) pair grid instead of scattered from the materialized
    pool edges: the pool is a uniform thinning of the reduced set
    (config.pool_cap) and edge thinning destroys cliqueness — measured
    3DLoMatch-protocol recall 1.0 -> 0.967 when the seed graph inherited a
    14336-slot pool. Known scale uses the beta window; estimate_scaling
    uses the ratio-histogram window (|bin - peak| <= 1, the reduced-set
    membership test, registration.cc:744-752) with the peak taken as the
    median bin of the pool members (which are peak +-1 members by
    construction). The rebuild costs two (C, C) distance grids,
    paid at most once and only by stagnating pairs (the seed is
    escalation-gated). Greedy-clique quality itself is backed by
    tests/test_clique.py::TestGreedyVsExact.

    Returns (WarmState with first_time = ~ok, ok () bool).
    """
    c = ori_src.shape[1]
    cap = params.clique_cap
    dtype = ori_src.dtype

    if active is not None and c <= params.dense_init_max_c:
        adj = dense_consistency_adjacency(
            ori_src, ori_dst, red_i, red_j, red_pool, params, active
        )
    else:
        slot_ok = jnp.arange(red_i.shape[0]) < red_pool
        adj = jnp.zeros((c, c), bool)
        adj = adj.at[red_i, red_j].max(slot_ok)
        adj = adj.at[red_j, red_i].max(slot_ok)
    # Triangle ordering, not core numbers: the ratio-histogram window's
    # noise region out-cores the inlier clique and core-seeded greedy lands
    # in noise (measured 5 vs exact 121; clique/kcore.triangle_scores).
    clique = greedy_clique(adj, order_scores=triangle_scores(adj))
    m = jnp.minimum(jnp.sum(clique, dtype=jnp.int32), cap)

    # Compact clique member indices to (cap,) (cumsum compaction; members
    # beyond the cap are dropped — the chain then spans the first cap).
    pos = jnp.cumsum(clique.astype(jnp.int32)) - 1
    write = jnp.where(clique & (pos < cap), pos, cap)
    cq = (
        jnp.zeros((cap + 1,), jnp.int32)
        .at[write]
        .set(jnp.arange(c, dtype=jnp.int32), mode="drop")[:cap]
    )
    # Chain TIMs with wrap-around over the clique points (upstream CHAIN
    # graph, the solver/classic.py rotation TIM set).
    nxt = (jnp.arange(cap) + 1) % jnp.maximum(m, 1)
    tim_active = jnp.arange(cap) < m

    res = basic_step(
        ori_src, ori_dst, cq, cq[nxt], tim_active, params, key,
        WarmState.initial(dtype),
    )
    ok = m >= params.clique_seed_min_size
    warm = WarmState(
        scale=jnp.where(ok, res.scale, jnp.ones((), dtype)),
        rotation=jnp.where(ok, res.rotation, jnp.eye(3, dtype=dtype)),
        translation=jnp.where(ok, res.translation, jnp.zeros((3,), dtype)),
        first_time=~ok,
    )
    return warm, ok


# =============================================================================
# Stage 2: sample the L-sampled set for one host round
# =============================================================================


@functools.partial(jax.jit, static_argnames=("params", "num_points"))
def _sample_stage(
    red_i: jax.Array,
    red_j: jax.Array,
    red_count: jax.Array,
    pool: jax.Array,
    l_rate: jax.Array,
    params: SolverParams,
    key: jax.Array,
    num_points: int,
):
    """Draw floor(|reduced| * L_sampled_rate) TIM indices without
    replacement (registration.cc:834-895). Gumbel-top-k over the compacted
    reduced array gives a uniform random subset; if the floor is 0 the whole
    reduced set is used (registration.cc:839-847). Sizes cap at sampled_cap.

    red_count is the (possibly estimated) |reduced| driving the sample-size
    rule; pool is the number of materialized members in red_i/red_j.

    Returns (sampled tim idx_i (S,), idx_j (S,), slot mask (S,),
    sampled_count (), sampled point mask (C,)).
    """
    r_cap = red_i.shape[0]
    cap = min(params.sampled_cap, r_cap)
    want = jnp.floor(red_count.astype(jnp.float32) * l_rate).astype(jnp.int32)
    want = jnp.where(want == 0, red_count, want)
    count = jnp.minimum(jnp.minimum(want, cap), pool)

    slot_ok = jnp.arange(r_cap) < pool
    g = jax.random.gumbel(key, (r_cap,), dtype=jnp.float32)
    score = jnp.where(slot_ok, g, -jnp.inf)
    # Gumbel keys are the randomness — an approx top-k of random keys is
    # still a uniform random subset, at a fraction of the exact top_k's
    # cost over the (r_cap,) pool (sorted output keeps -inf slots last).
    # Recall misses can return fewer than `pool` valid slots when pool is
    # near cap; clamp count so padding slots never enter the sampled set.
    vals, top = jax.lax.approx_max_k(score, cap)
    count = jnp.minimum(count, jnp.sum(vals > -jnp.inf, dtype=jnp.int32))
    rank_ok = jnp.arange(cap) < count
    # Invalid slots point at pair 0 but stay masked everywhere.
    s_i = jnp.where(rank_ok, red_i[top], 0)
    s_j = jnp.where(rank_ok, red_j[top], 0)

    pt_mask = jnp.zeros((num_points,), bool)
    pt_mask = pt_mask.at[s_i].max(rank_ok)
    pt_mask = pt_mask.at[s_j].max(rank_ok)
    return s_i, s_j, rank_ok, count, pt_mask


# =============================================================================
# Stage 3: the local RANSAC loop (batched hypotheses)
# =============================================================================


class HypExtras(NamedTuple):
    """Per-hypothesis stage masks of the winning basic iteration — the data
    behind the reference's inlier getters (registration.h:600-746):
    getScaleInliersMask / getRotationInliersMask over the basic TIM set
    (indexed by b_i/b_j into the original points) and
    getTranslationInliersMask over points."""

    b_i: jax.Array  # (bcap,) int32 — basic TIM endpoint indices
    b_j: jax.Array  # (bcap,) int32
    scale_inliers: jax.Array  # (bcap,) bool
    rotation_inliers: jax.Array  # (bcap,) bool
    translation_inliers: jax.Array  # (C,) bool
    translation_points: jax.Array  # (C,) bool — points fed to translation

    @staticmethod
    def zeros(bcap: int, c: int) -> "HypExtras":
        return HypExtras(
            b_i=jnp.zeros((bcap,), jnp.int32),
            b_j=jnp.zeros((bcap,), jnp.int32),
            scale_inliers=jnp.zeros((bcap,), bool),
            rotation_inliers=jnp.zeros((bcap,), bool),
            translation_inliers=jnp.zeros((c,), bool),
            translation_points=jnp.zeros((c,), bool),
        )


class LocalState(NamedTuple):
    key: jax.Array
    warm: WarmState
    best: WarmState  # best sampled solution so far (first_time unused)
    best_count: jax.Array  # () int32 — best sampled inlier count
    local_r: jax.Array  # () int32
    pro_local: jax.Array  # ()
    iterations: jax.Array  # () int32 — batches consumed
    hypotheses: jax.Array  # () int32 — hypotheses consumed
    escalate: jax.Array  # () bool — stagnation triggered
    done: jax.Array  # () bool
    extras: HypExtras  # stage masks of the current best hypothesis
    extras_valid: jax.Array  # () bool — extras ever populated (False when
    # the warm/GROR seed never got displaced; the zeros placeholder must
    # not back the inlier getters)


def _similar(
    sol_scale, sol_rot, sol_trans, warm: WarmState, params: SolverParams
) -> jax.Array:
    """Early-accept similarity test (registration.cc:1261-1264): scale within
    scale_noise, geodesic rotation distance within rotation_similar, and
    translation distance within translation_noise. The noise values here are
    the inner-loop constants (the reference reads its globals, which the
    inner override pins to 2*0.05 and 0.05)."""
    scale_noise = 2.0 * params.inner_noise_bound * np.sqrt(params.inner_cbar2)
    trans_noise = params.inner_noise_bound * np.sqrt(params.inner_cbar2)
    return (
        (jnp.abs(warm.scale - sol_scale) <= scale_noise)
        & (angular_error_rad(warm.rotation, sol_rot) <= params.rotation_similar)
        & (jnp.linalg.norm(warm.translation - sol_trans) <= trans_noise)
    )


GNC_PATHS = ("auto", "xla", "interpret")


@functools.partial(jax.jit, static_argnames=("params", "gnc_path"))
def _local_stage(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    s_i: jax.Array,
    s_j: jax.Array,
    s_ok: jax.Array,
    sampled_count: jax.Array,
    sampled_pt_mask: jax.Array,
    b_rate: jax.Array,
    b_rate_is_one: jax.Array,
    host_r: jax.Array,
    warm_in: WarmState,
    thr: jax.Array,
    params: SolverParams,
    key: jax.Array,
    gnc_path: str = "auto",
):
    """Run the local RANSAC loop for one host round
    (registration.cc:903-1398) with vmapped hypothesis batches.

    gnc_path picks how float32 GNC_TLS batches run (kernel_checks compares
    the paths; users keep "auto"): "auto" runs the whole-GNC kernel where
    the solve is compiled for CUDA and the vmapped XLA loop elsewhere,
    "xla" always takes the XLA loop, "interpret" runs the kernel in the
    Pallas interpreter on any platform.

    Returns (best sampled solution WarmState, best_count, local_r, warm_out,
    escalate flag, hypotheses consumed).
    """
    if gnc_path not in GNC_PATHS:
        raise ValueError(f"gnc_path {gnc_path!r} not in {GNC_PATHS}")
    mode = params.resolve_inlier_selection()
    use_clique = mode != InlierSelectionMode.NONE
    cap = s_i.shape[0]  # min(params.sampled_cap, L) — set by _sample_stage
    bcap = min(params.basic_cap, cap)
    batch = params.hypothesis_batch
    c = ori_src.shape[1]
    dtype = ori_src.dtype

    n_sampled_pts = jnp.maximum(jnp.sum(sampled_pt_mask), 1).astype(dtype)
    basic_choose = jnp.floor(sampled_count.astype(dtype) * b_rate).astype(jnp.int32)
    basic_choose = jnp.clip(basic_choose, 1, bcap)
    # b_rate == 1.0: basic set = whole sampled set (capped).
    basic_choose = jnp.where(b_rate_is_one, jnp.minimum(sampled_count, bcap), basic_choose)

    def eval_hypothesis(hkey, warm):
        """One basic iteration (registration.cc:908-1256) at static shapes."""
        k_pick, k_scale = jax.random.split(hkey)
        g = jax.random.gumbel(k_pick, (cap,), dtype=jnp.float32)
        score = jnp.where(s_ok, g, -jnp.inf)
        # Approx top-k of random keys = uniform subset (see _sample_stage);
        # clamp by the valid-slot count so recall misses never admit
        # padding TIMs.
        vals, top = jax.lax.approx_max_k(score, bcap)
        n_valid = jnp.sum(vals > -jnp.inf, dtype=jnp.int32)
        sel_ok = jnp.arange(bcap) < jnp.minimum(basic_choose, n_valid)
        b_i = jnp.where(sel_ok, s_i[top], 0)
        b_j = jnp.where(sel_ok, s_j[top], 0)

        # Clique point selection only at the b_rate == 1.0 escalation
        # (registration.cc:1000-1056, 1238-1244): graph over points from the
        # scale-consistency inliers of the basic TIM set. The adjacency
        # build + clique search live inside the cond so the (C, C) matrix
        # is only materialized on the escalated path.
        clique_pts = None
        if use_clique:

            def run_clique():
                src_t = ori_src[:, b_j] - ori_src[:, b_i]
                dst_t = ori_dst[:, b_j] - ori_dst[:, b_i]
                _, sc_inl, _ = select_scale_inliers(
                    src_t, dst_t, params.inner_noise_bound, params.inner_cbar2,
                    active=sel_ok,
                )
                adj = jnp.zeros((c, c), bool)
                adj = adj.at[b_i, b_j].max(sc_inl)
                adj = adj.at[b_j, b_i].max(sc_inl)
                if (
                    mode == InlierSelectionMode.PMC_EXACT
                    and params.exact_clique_callback
                ):
                    # Exact PMC parity (graph.cc:84-124): host callback into
                    # the native branch-and-bound. Opt-in (config.py) — the
                    # default keeps the on-device greedy heuristic.
                    from psulvsb_tpu.clique import pmc as _pmc

                    time_limit = params.max_clique_time_limit

                    def _host_exact(adj_np, act_np):
                        import numpy as _np

                        a = _np.asarray(adj_np, bool)
                        act = _np.asarray(act_np, bool)
                        a = a & act[None, :] & act[:, None]
                        members = _pmc.exact_max_clique(a, time_limit)
                        out = _np.zeros(a.shape[0], bool)
                        out[members] = True
                        return out

                    return jax.pure_callback(
                        _host_exact,
                        jax.ShapeDtypeStruct((c,), jnp.bool_),
                        adj,
                        sampled_pt_mask,
                        vmap_method="sequential",
                    )
                return greedy_clique(
                    adj, sampled_pt_mask,
                    order_scores=triangle_scores(adj, sampled_pt_mask),
                )

            clique_pts = jax.lax.cond(
                b_rate_is_one, run_clique, lambda: jnp.zeros((c,), bool)
            )

        res = basic_step(
            ori_src,
            ori_dst,
            b_i,
            b_j,
            sel_ok,
            params,
            k_scale,
            warm,
            clique_points=clique_pts,
            use_clique_points=b_rate_is_one if use_clique else False,
        )
        count, _ = score_transform(
            ori_src, ori_dst, sampled_pt_mask, res.scale, res.rotation,
            res.translation, thr,
        )
        sim = _similar(res.scale, res.rotation, res.translation, warm, params)
        extras = HypExtras(
            b_i=b_i,
            b_j=b_j,
            scale_inliers=res.scale_inliers,
            rotation_inliers=res.rotation_inliers,
            translation_inliers=res.translation_point_inliers,
            translation_points=res.translation_points,
        )
        return res.scale, res.rotation, res.translation, count, sim, extras

    def _pick_basic(hkey):
        """Sample one hypothesis' basic TIM set (vmapped)."""
        g = jax.random.gumbel(hkey, (cap,), dtype=jnp.float32)
        score = jnp.where(s_ok, g, -jnp.inf)
        vals, top = jax.lax.approx_max_k(score, bcap)
        n_valid = jnp.sum(vals > -jnp.inf, dtype=jnp.int32)
        sel_ok = jnp.arange(bcap) < jnp.minimum(basic_choose, n_valid)
        b_i = jnp.where(sel_ok, s_i[top], 0)
        b_j = jnp.where(sel_ok, s_j[top], 0)
        return b_i, b_j, sel_ok

    def eval_batch_pallas(hkeys, warm, interpret=False):
        """Batched hypothesis evaluation with the whole-GNC Pallas kernel
        (ops/pallas_gnc.py): per-hypothesis sampling + scale (vmapped),
        ONE kernel for all GNC loops, then translation + scoring (vmapped).
        Semantics identical to eval_hypothesis for GNC_TLS without the
        clique stage; the b_rate == 1.0 clique round falls back to the
        vmapped path in batch_body."""
        nb = jnp.asarray(params.inner_noise_bound, dtype)
        cb2 = jnp.asarray(params.inner_cbar2, dtype)

        def pre(hkey):
            k_pick, k_scale = jax.random.split(hkey)
            b_i, b_j, sel_ok = _pick_basic(k_pick)
            src_t = ori_src[:, b_j] - ori_src[:, b_i]
            dst_t = ori_dst[:, b_j] - ori_dst[:, b_i]
            if params.estimate_scaling:
                scale, sc_inl, _ = solve_scale_tls(
                    src_t, dst_t, nb, cb2, k_scale, active=sel_ok,
                    warm_scale=warm.scale, use_warm=~warm.first_time,
                    max_draws=params.scale_max_draws,
                )
                rot_mask = sc_inl
            else:
                scale, sc_inl, _ = select_scale_inliers(src_t, dst_t, nb, cb2, sel_ok)
                # Known scale: rotation consumes ALL basic TIMs
                # (registration.cc:984-991); the scale-inlier mask is kept
                # only for the getter surface.
                rot_mask = sel_ok
            return b_i, b_j, scale, sc_inl, rot_mask, src_t, dst_t

        b_i_b, b_j_b, scale_b, sc_inl_b, rot_mask_b, src_t_b, dst_t_b = jax.vmap(pre)(
            hkeys
        )

        inv_s = 1.0 / jnp.maximum(scale_b, 1e-30)  # (batch,)
        from psulvsb_tpu.ops.pallas_gnc import gnc_batch

        rot_b, rot_inl_b = gnc_batch(
            src_t_b,  # (B, 3, N)
            dst_t_b * inv_s[:, None, None],
            rot_mask_b,
            nb * 2.0 * inv_s,
            warm.rotation,
            ~warm.first_time,
            max_iterations=params.inner_rotation_max_iterations,
            gnc_factor=params.inner_rotation_gnc_factor,
            cost_threshold=params.inner_rotation_cost_threshold,
            interpret=interpret,
        )

        def post(b_i, b_j, sc_inl, rot_inl, scale, rotation, inv_s_h):
            if 2 * bcap < c:
                # Compact endpoint translation: sorts/cumsums sized 2*bcap
                # instead of C (identical estimate; see
                # robust/translation.py::solve_translation_endpoints).
                t_s, t_inl, trans_points, _ = solve_translation_endpoints(
                    ori_src, ori_dst, rotation, scale, b_i, b_j, rot_inl,
                    nb, cb2,
                    warm_translation=warm.translation,
                    use_warm=~warm.first_time,
                )
            else:
                trans_points = endpoint_mask(b_i, b_j, rot_inl, c)
                moved = scale * mm(rotation, ori_src)
                t_s, t_inl, _ = solve_translation(
                    moved, ori_dst, nb, cb2, active=trans_points,
                    warm_translation=warm.translation,
                    use_warm=~warm.first_time,
                )
            translation = t_s * inv_s_h
            count, _ = score_transform(
                ori_src, ori_dst, sampled_pt_mask, scale, rotation,
                translation, thr,
            )
            sim = _similar(scale, rotation, translation, warm, params)
            extras = HypExtras(
                b_i=b_i,
                b_j=b_j,
                scale_inliers=sc_inl,
                rotation_inliers=rot_inl,
                translation_inliers=t_inl,
                translation_points=trans_points,
            )
            return translation, count, sim, extras

        transs, counts, sims, extras = jax.vmap(post)(
            b_i_b, b_j_b, sc_inl_b, rot_inl_b, scale_b, rot_b, inv_s
        )
        return scale_b, rot_b, transs, counts, sims, extras

    # float32 GNC_TLS batches run the whole-GNC kernel (ops/pallas_gnc.py)
    # where the solve is compiled for CUDA — faster whole solves on the
    # H100 (PERF.md; kernel_checks.check_gnc_solve times both paths); every
    # other platform, float64 solves, and the escalated clique round
    # (b_rate == 1.0) take the vmapped XLA loop.
    use_gnc_kernel = (
        params.rotation_estimation_algorithm
        == RotationEstimationAlgorithm.GNC_TLS
        and dtype == jnp.float32
        and gnc_path != "xla"
    )

    def batch_body(st: LocalState) -> LocalState:
        key, sub = jax.random.split(st.key)
        hkeys = jax.random.split(sub, batch)

        def eval_vmapped():
            return jax.vmap(eval_hypothesis, in_axes=(0, None))(hkeys, st.warm)

        def eval_kernel(interpret=False):
            return jax.lax.cond(
                b_rate_is_one, eval_vmapped,
                lambda: eval_batch_pallas(hkeys, st.warm, interpret),
            )

        if use_gnc_kernel and gnc_path == "interpret":
            scales, rots, transs, counts, sims, extras_b = eval_kernel(True)
        elif use_gnc_kernel:
            scales, rots, transs, counts, sims, extras_b = (
                jax.lax.platform_dependent(cuda=eval_kernel, default=eval_vmapped)
            )
        else:
            scales, rots, transs, counts, sims, extras_b = eval_vmapped()

        first_time = st.warm.first_time
        sims = sims & ~first_time  # early-accept only after first scoring

        # --- replay the serial acceptance over the batch -------------------
        t_idx = jnp.arange(batch, dtype=jnp.int32)
        # Baseline: when warm, the serial loop re-baselines the running best
        # to last_best's own sampled count each iteration
        # (registration.cc:1289-1315); that equals scoring warm directly.
        # The reference skips this re-baseline at the escalated clique round
        # (`!first_time && b_sampled_rate < 1.0`, registration.cc:1289), so
        # there the round's hypothesis starts from a zero baseline and takes
        # the host best on ties — keep that tie-rule.
        warm_count, _ = score_transform(
            ori_src, ori_dst, sampled_pt_mask, st.warm.scale, st.warm.rotation,
            st.warm.translation, thr,
        )
        baseline = jnp.where(first_time | b_rate_is_one, jnp.int32(-1), warm_count)

        run_best = jax.lax.cummax(jnp.maximum(counts, baseline))
        local_r_t = st.local_r + t_idx + 1
        w_t = run_best.astype(dtype) / n_sampled_pts
        pro_t = 1.0 - jnp.power(1.0 - w_t, local_r_t.astype(dtype))

        # Early-accept: first similar hypothesis ends the local loop with
        # pro_local = 1 (registration.cc:1261-1282). Its local_r bump is
        # host_r + 1 if it is the first hypothesis of the round, else 1.
        sim_any = jnp.any(sims)
        # int32 pins: under x64 argmax returns int64, which would widen the
        # int32 loop-carry counters below and break the while_loop contract.
        sim_t = jnp.argmax(sims).astype(jnp.int32)

        stagn_t = (local_r_t >= params.local_max_iter) & (
            pro_t <= params.stagnation_min_pro_local
        )
        stagn_t = stagn_t | b_rate_is_one  # registration.cc:1361
        conf_t = pro_t > params.local_confidence
        stop_t_mask = conf_t | stagn_t
        stop_any = jnp.any(stop_t_mask)
        stop_t = jnp.where(
            stop_any, jnp.argmax(stop_t_mask), batch - 1
        ).astype(jnp.int32)

        # The effective cut: earliest of early-accept and stop.
        cut = jnp.where(sim_any & (sim_t <= stop_t), sim_t, stop_t)
        is_sim_cut = sim_any & (sim_t <= stop_t)

        # Winner among hypotheses [0..cut]: first max of counts vs baseline.
        in_win = t_idx <= cut
        cmask = jnp.where(in_win, counts, jnp.int32(-2147483648))
        best_h = jnp.argmax(cmask).astype(jnp.int32)
        batch_best_count = cmask[best_h]
        take_batch = (batch_best_count > baseline) | first_time

        new_best_scale = jnp.where(take_batch, scales[best_h], st.warm.scale)
        new_best_rot = jnp.where(take_batch, rots[best_h], st.warm.rotation)
        new_best_trans = jnp.where(take_batch, transs[best_h], st.warm.translation)
        new_best_count = jnp.maximum(batch_best_count, baseline)

        # Early-accept overrides the winner with the similar hypothesis and
        # skips count bookkeeping (registration.cc:1278-1281).
        new_best_scale = jnp.where(is_sim_cut, scales[sim_t], new_best_scale)
        new_best_rot = jnp.where(is_sim_cut, rots[sim_t], new_best_rot)
        new_best_trans = jnp.where(is_sim_cut, transs[sim_t], new_best_trans)

        consumed = cut + 1
        # The serial loop clears sampled_first_time after every hypothesis
        # (registration.cc:1270-1276), so the host_r+1 bump applies only when
        # the round's literal first hypothesis is the similar one; a sim at
        # position k>0 contributes k+1 like any consumed prefix.
        sampled_first = st.hypotheses == 0
        sim_bump = jnp.where(
            sampled_first & is_sim_cut & (sim_t == 0), host_r + 1, consumed
        )
        new_local_r = st.local_r + jnp.where(is_sim_cut, sim_bump, consumed)

        pro_after = jnp.where(is_sim_cut | stop_any, 1.0, pro_t[batch - 1])
        pro_after = jnp.where(
            stop_any & ~is_sim_cut & conf_t[stop_t], pro_t[stop_t], pro_after
        )
        done = is_sim_cut | stop_any
        escalate = st.escalate | (stop_any & ~is_sim_cut & stagn_t[stop_t] & ~conf_t[stop_t])

        new_warm = WarmState(
            scale=new_best_scale,
            rotation=new_best_rot,
            translation=new_best_trans,
            first_time=jnp.zeros((), bool),
        )
        # Stage masks follow the same winner selection: the early-accepted
        # similar hypothesis, else the batch winner when it displaces warm.
        sel_idx = jnp.where(is_sim_cut, sim_t, best_h)
        keep_new = is_sim_cut | take_batch
        extras_win = jax.tree.map(lambda x: x[sel_idx], extras_b)
        new_extras = jax.tree.map(
            lambda new, old: jnp.where(keep_new, new, old), extras_win, st.extras
        )
        return LocalState(
            key=key,
            warm=new_warm,
            best=new_warm,
            best_count=jnp.where(is_sim_cut, st.best_count, new_best_count),
            local_r=new_local_r,
            pro_local=pro_after,
            iterations=st.iterations + 1,
            hypotheses=st.hypotheses + consumed,
            escalate=escalate,
            done=done,
            extras=new_extras,
            extras_valid=st.extras_valid | keep_new,
        )

    init = LocalState(
        key=key,
        warm=warm_in,
        best=warm_in,
        best_count=jnp.int32(0),
        local_r=jnp.int32(0),
        pro_local=jnp.zeros((), dtype),
        iterations=jnp.int32(0),
        hypotheses=jnp.int32(0),
        escalate=jnp.zeros((), bool),
        done=jnp.zeros((), bool),
        extras=HypExtras.zeros(bcap, c),
        extras_valid=jnp.zeros((), bool),
    )
    # Hard ceiling on batches: the serial loop ends by confidence
    # (pro_local > 0.99) or stagnation (local_r >= local_max_iter with
    # pro_local <= 0.2). Between those bounds pro_local is monotone in
    # local_r, so ceiling_factor x local_max_iter hypotheses cover all but
    # mid-confidence plateaus; beyond the ceiling the round proceeds to host
    # scoring exactly as a confidence exit would (adversarial fixture:
    # tests/test_registration.py::TestPlateauCeiling).
    factor = params.local_batch_ceiling_factor
    max_batches = max(
        2, -(-factor * params.local_max_iter // params.hypothesis_batch) + 1
    )
    final = jax.lax.while_loop(
        lambda st: (~st.done) & (st.iterations < max_batches), batch_body, init
    )
    return final


# =============================================================================
# Stage 4: host scoring + probabilistic self-update bookkeeping
# =============================================================================


class HostState(NamedTuple):
    inlier_counter: jax.Array  # (C,) int32 — weightedSVD weights
    inlier_history: jax.Array  # (C,) int32 in {-1, 0, 1}
    residual_history: jax.Array  # (C,)
    final_inliers: jax.Array  # (C,) int32 {0, 1}
    keep_mask: jax.Array  # (C,) int32 {1, 0, -1}
    active: jax.Array  # (C,) bool — current correspondence set
    inl_kept: jax.Array  # (C,) bool — kept host-inliers (inlier_map)
    best: WarmState  # best host solution
    best_count: jax.Array  # () int32
    host_r: jax.Array  # () int32
    pro_host: jax.Array  # ()

    @staticmethod
    def initial(c: int, keep_mask: jax.Array, dtype=jnp.float32) -> "HostState":
        return HostState(
            inlier_counter=jnp.zeros((c,), jnp.int32),
            inlier_history=jnp.full((c,), -1, jnp.int32),
            residual_history=jnp.zeros((c,), dtype),
            final_inliers=jnp.zeros((c,), jnp.int32),
            keep_mask=keep_mask,
            active=keep_mask == 1,
            inl_kept=jnp.zeros((c,), bool),
            best=WarmState.initial(dtype),
            best_count=jnp.int32(0),
            host_r=jnp.int32(0),
            pro_host=jnp.zeros((), dtype),
        )


@functools.partial(jax.jit, static_argnames=("params",))
def _host_stage(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    hs: HostState,
    best_sampled: WarmState,
    local_r: jax.Array,
    b_rate_is_one: jax.Array,
    thr: jax.Array,
    params: SolverParams,
    key: jax.Array,
):
    """Host scoring of the local round's winner on the ORIGINAL set plus the
    probabilistic self-update bookkeeping (registration.cc:1399-1488).

    Returns (new HostState, new_corr mask (C,) bool, take () bool — whether
    this round's sampled best displaced the host best).
    """
    c = ori_src.shape[1]
    dtype = ori_src.dtype
    host_r = hs.host_r + local_r

    moved = best_sampled.scale * (
        mm(best_sampled.rotation, ori_src) + best_sampled.translation[:, None]
    )
    res = jnp.sqrt(jnp.sum((ori_dst - moved) ** 2, axis=0))
    # keep_mask == -2 marks PADDING columns (bucket-padded inputs): unlike
    # the pre-filter's -1 (real points the reference still scores,
    # registration.cc:1422), padding must never vote.
    real = hs.keep_mask > -2
    is_inl = (res <= thr) & real
    curr_count = jnp.sum(is_inl, dtype=jnp.int32)

    inlier_counter = hs.inlier_counter + is_inl.astype(jnp.int32)

    # Probabilistic re-admission (registration.cc:1428-1436): a point outside
    # the current set (keep == 0) becomes a new correspondence if its history
    # is fresh (-1) / inlier (1), or — when previously an outlier — with
    # probability P(inlier | residual) from the chi(3) survival function.
    u = jax.random.uniform(key, (c,), dtype=dtype)
    p_in = inlier_probability(res, params.noise_bound_dataset)
    readmit_ok = (
        (hs.inlier_history == -1)
        | (hs.inlier_history == 1)
        | ((hs.inlier_history == 0) & (u <= p_in))
    )
    new_corr = is_inl & (hs.keep_mask == 0) & readmit_ok
    if not params.enable_self_update:
        # C-RANSAC baseline variant (registration_WT.cc): no probabilistic
        # re-admission of dropped correspondences.
        new_corr = jnp.zeros_like(new_corr)

    # Demotion on miss (published intent of the buggy registration.cc:1438;
    # see module docstring): previously-outlier points, and previously-inlier
    # points failing a survival draw on their *previous* residual, lose their
    # final-inlier flag.
    p_prev = inlier_probability(hs.residual_history, params.noise_bound_dataset)
    demote = (~is_inl) & (
        (hs.inlier_history == 0) | ((hs.inlier_history == 1) & (u > p_prev))
    )

    final_inliers = hs.final_inliers
    final_inliers = jnp.where(new_corr, 1, final_inliers)
    kept_inl = is_inl & (hs.keep_mask == 1)
    final_inliers = jnp.where(kept_inl, 1, final_inliers)
    final_inliers = jnp.where(demote, 0, final_inliers)

    inlier_history = jnp.where(is_inl, 1, 0)
    residual_history = res

    # Host best update (registration.cc:1454-1462).
    take = (
        (curr_count > hs.best_count)
        | (hs.pro_host == 0.0)
        | (b_rate_is_one & (curr_count >= hs.best_count))
    )
    best = WarmState(
        scale=jnp.where(take, best_sampled.scale, hs.best.scale),
        rotation=jnp.where(take, best_sampled.rotation, hs.best.rotation),
        translation=jnp.where(take, best_sampled.translation, hs.best.translation),
        first_time=jnp.zeros((), bool),
    )
    best_count = jnp.where(take, curr_count, hs.best_count)
    n_real = jnp.maximum(jnp.sum(real, dtype=jnp.int32), 1).astype(dtype)
    w = best_count.astype(dtype) / n_real
    pro_host = 1.0 - jnp.power(1.0 - w, host_r.astype(dtype))

    new_hs = HostState(
        inlier_counter=inlier_counter,
        inlier_history=inlier_history,
        residual_history=residual_history,
        final_inliers=final_inliers,
        keep_mask=jnp.where(new_corr, 1, hs.keep_mask),
        active=hs.active | new_corr,
        inl_kept=kept_inl,
        best=best,
        best_count=best_count,
        host_r=host_r,
        pro_host=pro_host,
    )
    return new_hs, new_corr, take


@functools.partial(jax.jit, static_argnames=("params",))
def _self_update_pairs(
    red_i: jax.Array,
    red_j: jax.Array,
    red_count: jax.Array,
    pool: jax.Array,
    new_corr: jax.Array,
    inl_kept: jax.Array,
    params: SolverParams,
):
    """Append the self-update TIMs to the compacted reduced set
    (registration.cc:786-832): every pair between a newly admitted point and
    the kept host-inlier points (inlier_map) or another new point. Admitted
    points and members cap at self_update_new_cap/member_cap; appends beyond
    reduced_cap are dropped."""
    c = new_corr.shape[0]
    r_cap = red_i.shape[0]
    n_cap = params.self_update_new_cap
    m_cap = params.self_update_member_cap

    def compact(mask, cap):
        pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
        write = jnp.where(mask & (pos < cap), pos, cap)
        lst = jnp.full((cap + 1,), -1, jnp.int32).at[write].set(
            jnp.arange(c, dtype=jnp.int32), mode="drop"
        )
        return lst[:cap], jnp.minimum(jnp.sum(mask, dtype=jnp.int32), cap)

    member = inl_kept | new_corr
    new_list, n_new = compact(new_corr, n_cap)
    mem_list, n_mem = compact(member, m_cap)

    # (n_cap, m_cap) candidate grid; avoid double-counting new-new pairs by
    # requiring member > new when the member is itself new.
    nn = new_list[:, None]
    mm = mem_list[None, :]
    valid = (
        (jnp.arange(n_cap)[:, None] < n_new)
        & (jnp.arange(m_cap)[None, :] < n_mem)
        & (nn != mm)
        & (~new_corr[jnp.maximum(mm, 0)] | (mm > nn))
    )
    pi = jnp.minimum(nn, mm)
    pj = jnp.maximum(nn, mm)

    vf = valid.reshape(-1)
    pif = pi.reshape(-1)
    pjf = pj.reshape(-1)
    pos = jnp.cumsum(vf.astype(jnp.int32)) - 1
    dest = pool + pos
    write = jnp.where(vf & (dest < r_cap), dest, r_cap)
    red_i = jnp.concatenate([red_i, jnp.zeros((1,), jnp.int32)])
    red_j = jnp.concatenate([red_j, jnp.zeros((1,), jnp.int32)])
    red_i = red_i.at[write].set(pif, mode="drop")[:r_cap]
    red_j = red_j.at[write].set(pjf, mode="drop")[:r_cap]
    added = jnp.minimum(jnp.sum(vf, dtype=jnp.int32), r_cap - pool)
    # red_count is the |reduced| COUNT (clamped by reduced_cap, not by the
    # pool slot capacity r_cap — the count may legitimately exceed the
    # materialized pool, see config.pool_cap).
    return (
        red_i,
        red_j,
        jnp.minimum(red_count + added, params.reduced_cap),
        pool + added,
    )


# =============================================================================
# Stage 5: weighted-SVD refinement + RMSE gate
# =============================================================================


@functools.partial(jax.jit, static_argnames=("params",))
def _finalize_stage(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    hs: HostState,
    best_sampled: WarmState,
    params: SolverParams,
):
    """weightedSVD refinement seeded from the *sampled* best
    (registration.cc:1502-1525: init_transform uses rotation/translation_
    best_sampled) with per-point inlier-hit-count weights, accepted only if
    the masked RMSE over final_inliers improves.

    Scale-aware divergence (by intent, SURVEY.md §7.5): the reference's
    weightedSVD + calculateRMSE ignore the estimated scale
    (registration.cc:526-602 fit SE(3) between R*src+t and dst) — correct
    at its published known-scale protocols but self-defeating under
    unknownScale, where dst ≈ s*(R p + t) makes both RMSEs garbage and the
    "adjust" can replace a good solution with a broken one. Here the fit,
    the composition, and both RMSE gates run in the s*(R p + t) model with
    s = best_sampled.scale — the whole refine lives in the sampled-best
    frame, exactly mirroring the reference's structure (its init_transform,
    fit, and both gates all use the sampled best; the returned solution's
    scale stays the host best's, registration.cc:1510-1527, whose peak-bin
    consensus keeps it within a histogram bin of the sampled best's). At
    s = 1 every formula reduces exactly to the reference's."""
    s = best_sampled.scale
    s_safe = jnp.where(s > 0, s, jnp.ones_like(s))
    w = hs.inlier_counter.astype(ori_src.dtype)
    moved = s_safe * (
        mm(best_sampled.rotation, ori_src) + best_sampled.translation[:, None]
    )
    r_fit, t_fit = weighted_procrustes_srt(moved, ori_dst, w)
    # combined = final * initial (registration.cc:566), in the s*(R p + t)
    # convention: R_f*(s*(R p + t)) + t_f = s*(R_f R p + R_f t + t_f/s).
    r_adj = mm(r_fit, best_sampled.rotation)
    t_adj = mm(r_fit, best_sampled.translation) + t_fit / s_safe

    mask = hs.final_inliers == 1
    rmse_adj = masked_rmse(ori_src, ori_dst, mask, r_adj, t_adj, scale=s_safe)
    rmse_ori = masked_rmse(
        ori_src, ori_dst, mask, best_sampled.rotation,
        best_sampled.translation, scale=s_safe,
    )
    better = rmse_adj < rmse_ori
    rotation = jnp.where(better, r_adj, hs.best.rotation)
    translation = jnp.where(better, t_adj, hs.best.translation)

    if params.translation_rescue:
        # Repeated-geometry translation aliasing rescue: re-stab over ALL
        # real correspondences under the final rotation, adopt only on a
        # strict global-support improvement (config.py translation_rescue;
        # mechanism + measurements: docs/FRONTEND_FAILURES.md). Uses the
        # host best's scale — the model of the returned solution.
        t_res, sup_new, sup_cur = global_translation_vote(
            ori_src, ori_dst, rotation, hs.best.scale,
            hs.keep_mask > -2, params.noise_bound, params.cbar2,
            translation,
        )
        translation = jnp.where(sup_new > sup_cur, t_res, translation)

    return rotation, translation, better


# =============================================================================
# Orchestration
# =============================================================================


def psulvsb_solve(
    ori_src,
    ori_dst,
    keep_mask,
    params: SolverParams,
    key: jax.Array,
    profile: bool = False,
) -> tuple[RegistrationSolution, dict]:
    """Full PSULVSB solve.

    ori_src/ori_dst: (3, C) original correspondence matrices (padded columns
    allowed via keep_mask == -1 entries at the tail... callers should pad
    with keep_mask=-1 so padded points are never scored).
    keep_mask: (C,) int32 {1, 0, -1} from the histogram pre-filter.

    The host-round loop runs in Python (5 rounds max, wall-clock budget
    between rounds — the reference checks time at the same boundary,
    registration.cc:1475); all heavy stages are jitted.
    """
    t_start = time.monotonic()
    ori_src = jnp.asarray(ori_src)
    ori_dst = jnp.asarray(ori_dst)
    keep_mask = jnp.asarray(keep_mask, jnp.int32)
    c = ori_src.shape[1]
    dtype = ori_src.dtype

    # profile=True: per-stage wall clock with a device sync after every
    # stage dispatch (info["stage_s"]). The syncs serialize host and device,
    # so profiled elapsed_s exceeds an unprofiled run — use for attribution,
    # not for headline latency.
    stage_s: dict[str, float] = {}

    def timed(name, fn, *args):
        if not profile:
            return fn(*args)
        t0 = time.monotonic()
        out = jax.block_until_ready(fn(*args))
        stage_s[name] = stage_s.get(name, 0.0) + (time.monotonic() - t0)
        return out

    key, k_init = jax.random.split(key)
    red_i, red_j, red_count, red_pool = timed(
        "init", _init_stage, ori_src, ori_dst, keep_mask, params, k_init
    )

    n_reduced_pts = int(jnp.sum(keep_mask == 1))
    # adoptive_thr_multiplier = 1 + |reduced| / |ori| (registration.cc:669).
    n_real = int(jnp.sum(keep_mask >= -1))  # all C columns count as ori
    thr = jnp.asarray(params.pr_noise * (1.0 + n_reduced_pts / max(n_real, 1)), dtype)

    hs = HostState.initial(c, keep_mask, dtype)
    warm = WarmState.initial(dtype)
    gror_used = False
    if params.gror_init:
        # GROR initial alignment (registration_artificial.cc:571-576): seed
        # the warm state from GROR's (R, t) so the local loop baselines
        # against it and GNC warm-starts from its rotation. Runs on all real
        # correspondences (padding keep_mask == -2 excluded) — GROR is an
        # independent front stage, not subject to the pre-filter's discards.
        from psulvsb_tpu.gror.gror import gror_align

        g = timed(
            "gror",
            lambda: gror_align(
                ori_src, ori_dst, params.gror_resolution, params.gror_k_optimal,
                corr_active=keep_mask > -2,
            ),
        )
        gror_ok = bool(jnp.sum(g.inliers) >= 3)
        if gror_ok:
            warm = WarmState(
                scale=jnp.ones((), dtype),
                rotation=g.rotation.astype(dtype),
                translation=g.translation.astype(dtype),
                first_time=jnp.zeros((), bool),
            )
            gror_used = True
    if params.clique_eager:
        # A successful clique seed wins over GROR (it is built from this
        # pair's own consistency graph) and the key split is unconditional
        # — both exactly as in solver/fused.py, so staged/fused parity
        # holds for every gror_init x clique_init combination.
        key, k_seed = jax.random.split(key)
        warm_seed, seed_ok = timed(
            "clique_seed", _clique_seed_stage,
            ori_src, ori_dst, red_i, red_j, red_pool, params, k_seed,
            keep_mask == 1,
        )
        if bool(seed_ok):
            warm = warm_seed
    lazy_clique = params.clique_lazy
    clique_seeded = False
    rate_idx = 0
    longholi = False
    best_sampled = warm
    best_extras: HypExtras | None = None
    rounds = 0
    total_hypotheses = 0  # "basic count" — iteration stats the WT variant
    total_local_batches = 0  # writes to static.txt (registration_WT.cc)

    for _round in range(params.max_host_rounds):
        rounds += 1
        l_rate, b_rate = RATE_SCHEDULE[rate_idx]
        b_one = jnp.asarray(b_rate >= 1.0)

        key, k_samp, k_local, k_host = jax.random.split(key, 4)
        s_i, s_j, s_ok, s_count, s_pts = timed(
            "sample", _sample_stage,
            red_i, red_j, red_count, red_pool, jnp.asarray(l_rate, dtype),
            params, k_samp, c,
        )

        local = timed(
            "local", _local_stage,
            ori_src, ori_dst, s_i, s_j, s_ok, s_count, s_pts,
            jnp.asarray(b_rate, dtype), b_one, hs.host_r, warm, thr, params, k_local,
        )
        best_sampled = local.best
        total_hypotheses += int(local.hypotheses)
        total_local_batches += int(local.iterations)

        hs, new_corr, host_take = timed(
            "host", _host_stage,
            ori_src, ori_dst, hs, best_sampled, local.local_r, b_one, thr, params,
            k_host,
        )
        if bool(host_take):
            # The host best came from this round — its winning hypothesis's
            # stage masks back the inlier getters (registration.h:600-746).
            # When the warm/GROR seed survived every batch unbeaten, no
            # hypothesis's extras exist — the getters must see None rather
            # than the all-zeros placeholder.
            best_extras = local.extras if bool(local.extras_valid) else None
        warm = WarmState(
            scale=hs.best.scale,
            rotation=hs.best.rotation,
            translation=hs.best.translation,
            first_time=jnp.zeros((), bool),
        )

        # Stop checks at the host boundary (registration.cc:1475-1484).
        elapsed = time.monotonic() - t_start
        if (
            float(hs.pro_host) > params.host_confidence
            or longholi
            or elapsed > params.time_budget_s
        ):
            break
        if rate_idx == len(RATE_SCHEDULE) - 1:
            longholi = True

        # Rate escalation decided inside the local loop takes effect on the
        # next host round (registration.cc:1377-1388).
        if bool(local.escalate) and rate_idx < len(RATE_SCHEDULE) - 1:
            rate_idx += 1

        # Self-update: fold newly admitted points into the reduced TIM set.
        if int(jnp.sum(new_corr)) > 0:
            red_i, red_j, red_count, red_pool = timed(
                "self_update", _self_update_pairs,
                red_i, red_j, red_count, red_pool, new_corr, hs.inl_kept, params,
            )

        # Lazy clique-seeded warm start (config.py clique_init="auto"): on
        # the first stagnation-escalation, once, over the post-self-update
        # reduced set — mirrors solver/fused.py's in-scan lax.cond exactly
        # (same derived key, so staged/fused stay in parity).
        if lazy_clique and not clique_seeded and bool(local.escalate):
            clique_seeded = True
            warm_seed, seed_ok = timed(
                "clique_seed", _clique_seed_stage,
                ori_src, ori_dst, red_i, red_j, red_pool, params,
                jax.random.fold_in(k_host, 0x5EED),
                hs.keep_mask == 1,
            )
            if bool(seed_ok):
                warm = warm_seed

    # Final refinement (registration.cc:1499-1528).
    if params.enable_refinement and int(hs.best_count) != 0:
        rotation, translation, refined = timed(
            "finalize", _finalize_stage, ori_src, ori_dst, hs, best_sampled,
            params,
        )
    else:
        rotation, translation = hs.best.rotation, hs.best.translation
        refined = jnp.zeros((), bool)

    # The reference sets valid=true unconditionally on loop exit
    # (registration.cc:1531) and false only on the clique abort
    # (registration.cc:1032-1036); additionally flagging the zero-inlier
    # outcome invalid is a deliberate strengthening (failure detection,
    # SURVEY.md §5).
    solution = RegistrationSolution(
        valid=hs.best_count > 0,
        scale=hs.best.scale,
        rotation=rotation,
        translation=translation,
        final_inlier_count=hs.best_count,
    )
    info = {
        "pro_host": hs.pro_host,
        "host_r": hs.host_r,
        "rounds": rounds,
        "refined": refined,
        "inlier_counter": hs.inlier_counter,
        "final_inliers": hs.final_inliers,
        # Stage masks of the hypothesis behind the host best — the
        # getScaleInliersMask/getRotationInliersMask/getTranslationInliersMask
        # surface (registration.h:600-746). TIM-level masks are indexed by
        # the basic set's endpoint maps (basic_tims_i/j into ori columns).
        "scale_inliers": None if best_extras is None else best_extras.scale_inliers,
        "rotation_inliers": (
            None if best_extras is None else best_extras.rotation_inliers
        ),
        "translation_inliers": (
            None if best_extras is None else best_extras.translation_inliers
        ),
        "translation_points": (
            None if best_extras is None else best_extras.translation_points
        ),
        "basic_tims_i": None if best_extras is None else best_extras.b_i,
        "basic_tims_j": None if best_extras is None else best_extras.b_j,
        "gror_init": gror_used,
        "stage_s": stage_s if profile else None,
        "elapsed_s": time.monotonic() - t_start,
        # Iteration statistics (the WT variant's static.txt counters:
        # host rounds / local iterations / basic iterations).
        "total_hypotheses": total_hypotheses,
        "total_local_batches": total_local_batches,
    }
    return solution, info


def write_iteration_stats(path: str, info: dict) -> None:
    """static.txt-equivalent iteration-count dump (written by the WT variant
    and consumed by teaser_cpp_ply_main.cc:448-466)."""
    with open(path, "w") as f:
        f.write(f"{info['rounds']}\n")
        f.write(f"{info['total_local_batches']}\n")
        f.write(f"{info['total_hypotheses']}\n")
