"""Line-vector (translation-invariant measurement, TIM) set machinery.

The reference builds the full upper-triangular pair set serially
(registration.cc:693-732 — the O(C^2) hot loop) together with a scale-ratio
histogram (MaxScale=10000, binsize=20 bins per unit, i.e. bin width 0.05)
whose peak bin ±1 forms the initial "L reduced set"
(registration.cc:744-752).

Batched form: pair indices are static numpy constants per padded size; TIMs are
one gather + subtract; the histogram is a segment-sum; the peak±1 reduction
is a vectorized bin-membership mask. Pair validity is carried as a mask so
padded correspondences never produce TIMs.

`computeTIMs` (registration.cc:470-509) used by the classic decoupled path
orders pairs identically (i < j, segment-major), so `triu_pair_indices`
serves both.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=32)
def triu_pair_indices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (i, j) index arrays of all i < j pairs, in the reference's
    segment-major order (registration.cc:479-505): for i = 0..n-2, all
    j = i+1..n-1. Length L = n(n-1)/2.
    """
    iu = np.triu_indices(n, k=1)
    return iu[0].astype(np.int32), iu[1].astype(np.int32)


def compute_tims(
    v: jax.Array, active: jax.Array | None = None
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """All-pairs TIMs of a (3, N) point matrix.

    Returns (tims (3, L), idx_i (L,), idx_j (L,), pair_active (L,)) with
    tim_l = v[:, j_l] - v[:, i_l], matching computeTIMs
    (registration.cc:470-509) and the PSULVSB build loop
    (registration.cc:697-711, src.col(j) - src.col(i)).
    """
    n = v.shape[1]
    ii, jj = triu_pair_indices(n)
    ii = jnp.asarray(ii)
    jj = jnp.asarray(jj)
    tims = v[:, jj] - v[:, ii]
    if active is None:
        pair_active = jnp.ones((ii.shape[0],), dtype=bool)
    else:
        pair_active = active[ii] & active[jj]
    return tims, ii, jj, pair_active


def gather_tims(v: jax.Array, idx_i: jax.Array, idx_j: jax.Array) -> jax.Array:
    """TIMs for explicit pair lists: v[:, j] - v[:, i]."""
    return v[:, idx_j] - v[:, idx_i]


def scale_ratio_histogram(
    ratios: jax.Array,
    pair_active: jax.Array,
    max_scale: float = 10000.0,
    bins_per_unit: int = 20,
    num_bins: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Histogram of |dst_tim|/|src_tim| ratios.

    Reference semantics (registration.cc:687-729): H has MaxScale * binsize
    bins over [0, MaxScale] (bin width 1/binsize = 0.05); out-of-range
    ratios are clamped into the last/first bin. (The reference dynamically
    regrows MaxScale when a ratio exceeds it — registration.cc:714-718; here
    out-of-range ratios clamp to the last bin, which the peak search ignores
    unless the data is pathological.)

    Returns (counts (num_bins,) int32, bin index per ratio (L,) int32).
    """
    # Reference: H_index > H.size() or < 0 -> 0 (registration.cc:721-723);
    # binning geometry shared with ratio_bin_indices (single source).
    idx, num_bins = ratio_bin_indices(ratios, max_scale, bins_per_unit, num_bins)
    counts = jnp.zeros((num_bins,), jnp.int32).at[idx].add(
        pair_active.astype(jnp.int32)
    )
    return counts, idx


def ratio_bin_indices(
    ratios: jax.Array,
    max_scale: float = 10000.0,
    bins_per_unit: int = 20,
    num_bins: int | None = None,
) -> tuple[jax.Array, int]:
    """Bin index per ratio under the reference's histogram geometry
    (registration.cc:687-729) without building the histogram. Returns
    (idx (L,) int32, num_bins)."""
    if num_bins is None:
        num_bins = int(max_scale) * bins_per_unit
    idx = jnp.floor(ratios / max_scale * num_bins).astype(jnp.int32)
    idx = jnp.clip(idx, 0, num_bins - 1)
    idx = jnp.where(jnp.isfinite(ratios), idx, 0)
    return idx, num_bins


def sort_peak_bin(
    bin_idx: jax.Array, active: jax.Array, num_bins: int
) -> tuple[jax.Array, jax.Array]:
    """Histogram argmax without a histogram: sort the bin indices and find
    the longest run — the peak search only needs the max-count bin, never
    the full counts vector.

    Returns (peak bin, peak count). Inactive entries sort to a sentinel
    past num_bins and are excluded; with NO active entry the peak is bin 0
    with count 0 (the histogram-argmax convention — never the sentinel).
    """
    n = bin_idx.shape[0]
    s = jnp.sort(jnp.where(active, bin_idx, num_bins))
    pos = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), s[1:] != s[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_start, pos, 0))
    run_len = jnp.where(s < num_bins, pos - run_start + 1, 0)
    best = jnp.argmax(run_len)
    cnt = run_len[best]
    return jnp.where(cnt > 0, s[best], 0), cnt


def masked_random_compact(
    key: jax.Array,
    mask: jax.Array,
    idx_i: jax.Array,
    idx_j: jax.Array,
    cap: int,
    max_index: int = 1 << 30,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Compact a uniformly-random subset of the masked pairs into (cap,)
    arrays via one multi-operand sort (scatter-free; the random sort keys
    double as the uniform decimation when the mask count exceeds cap).

    max_index: static exclusive upper bound on the index values (the
    correspondence count C at the call site). When it fits 15 bits, (i, j)
    packs into one i32 payload — a 2-operand sort is cheaper than
    3-operand. Larger domains (pad_to_bucket grows unboundedly
    past 8192) take the 3-operand form: i*65536+j would wrap negative at
    i >= 32768 and unpack to garbage indices.

    Returns (red_i (cap,), red_j (cap,), count = min(#mask, cap)).
    """
    r = jax.random.randint(key, mask.shape, 0, jnp.int32(1 << 30))
    keys = jnp.where(mask, r, jnp.int32(1 << 30))  # non-members sort last
    total = jnp.sum(mask, dtype=jnp.int32)
    if max_index <= 1 << 15:
        packed = idx_i.astype(jnp.int32) * 65536 + idx_j.astype(jnp.int32)
        _, sp = jax.lax.sort((keys, packed), num_keys=1)
        return sp[:cap] // 65536, sp[:cap] % 65536, jnp.minimum(total, cap)
    _, si, sj = jax.lax.sort(
        (keys, idx_i.astype(jnp.int32), idx_j.astype(jnp.int32)), num_keys=1
    )
    return si[:cap], sj[:cap], jnp.minimum(total, cap)


def peak_bin_mask(
    counts: jax.Array, bin_idx: jax.Array, pair_active: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Membership mask of the histogram peak bin ±1 — the initial reduced
    line-vector set (registration.cc:744-752).

    Returns (reduced mask over pairs, peak bin index).
    """
    peak = jnp.argmax(counts)
    in_peak = jnp.abs(bin_idx - peak) <= 1
    return in_peak & pair_active, peak
