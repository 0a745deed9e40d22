"""Exact reductions over the C x C correspondence-pair grid, in plain
jnp/lax left to XLA.

The reference sweeps all C(C-1)/2 correspondence pairs serially: the
line-vector build with its scale-ratio histogram (registration.cc:693-752)
and GROR's node reliability (ia_gror.hpp:125-193). Here each pair's TIM
lengths come from direct coordinate differences — no
||a||^2 + ||b||^2 - 2ab matrix product, so no TF32 or cancellation error
can move a pair across a bin or window boundary — and the reductions are
one fused elementwise pass plus a scatter-add (histogram) or a sum.

Grids up to `block` rows are built whole; larger C is swept in row blocks
of (block, C) tiles under `lax.fori_loop`, so memory stays O(block * C).
Bin geometry matches the dense init (solver/psulvsb.py::_init_stage_dense):
bin = floor(ratio * bins_per_unit), clipped into [0, num_bins). The peak is
the histogram's first argmax, the lowest bin on ties — the rule
pairs/tims.py::sort_peak_bin and scale_ratio_histogram follow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def pair_lengths(
    rows_src: jax.Array, rows_dst: jax.Array, cols_src: jax.Array,
    cols_dst: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """TIM lengths ||src_j - src_i|| and ||dst_j - dst_i|| over the (R, K)
    grid of row points i (rows_*: (3, R)) and column points j (cols_*:
    (3, K)), from direct differences."""

    def lengths(r, c):
        sq = None
        for a in range(3):
            e = c[a][None, :] - r[a][:, None]
            sq = e * e if sq is None else sq + e * e
        return jnp.sqrt(sq)

    return lengths(rows_src, cols_src), lengths(rows_dst, cols_dst)


def ratio_bins(v1: jax.Array, v2: jax.Array, bins_per_unit: int,
               num_bins: int) -> jax.Array:
    """Histogram bin of each pair's length ratio v2 / v1 (zero-length
    source TIMs divide by 1, as the gather sweep does)."""
    ratio = v2 / jnp.where(v1 > 0, v1, 1.0)
    return jnp.clip(
        jnp.floor(ratio * bins_per_unit).astype(jnp.int32), 0, num_bins - 1
    )


def bin_counts(bins: jax.Array, valid: jax.Array, counts: jax.Array) -> jax.Array:
    """Add the valid entries of an integer bin grid to a histogram
    (scatter-add)."""
    return counts.at[bins.ravel()].add(valid.ravel().astype(jnp.int32))


def peak_window_count(counts: jax.Array, peak: jax.Array) -> jax.Array:
    """Pairs in bins peak-1..peak+1 — the size of the reduced set
    (registration.cc:744-752)."""
    b = jnp.arange(counts.shape[0])
    return jnp.sum(jnp.where(jnp.abs(b - peak) <= 1, counts, 0), dtype=jnp.int32)


def _row_blocks(src, dst, active, block):
    """Pad C to a multiple of the row block; padded columns are inactive."""
    c = src.shape[1]
    t = min(block, c)
    pad = (-c) % t
    src = jnp.pad(src.astype(jnp.float32), ((0, 0), (0, pad)))
    dst = jnp.pad(dst.astype(jnp.float32), ((0, 0), (0, pad)))
    act = jnp.pad(active, (0, pad))
    return src, dst, act, t, (c + pad) // t


def _sweep(src, dst, active, block, tile_fn, init):
    """Fold tile_fn(acc, v1, v2, valid) over (t, C) row tiles of the upper
    triangle i < j of active pairs."""
    if active is None:
        active = jnp.ones((src.shape[1],), bool)
    src, dst, act, t, n_blocks = _row_blocks(src, dst, active, block)
    cp = src.shape[1]
    col = jnp.arange(cp)

    def body(k, acc):
        r0 = k * t
        rs = jax.lax.dynamic_slice_in_dim(src, r0, t, axis=1)
        rd = jax.lax.dynamic_slice_in_dim(dst, r0, t, axis=1)
        ra = jax.lax.dynamic_slice_in_dim(act, r0, t)
        v1, v2 = pair_lengths(rs, rd, src, dst)
        row = r0 + jnp.arange(t)
        valid = (row[:, None] < col[None, :]) & ra[:, None] & act[None, :]
        return tile_fn(acc, v1, v2, valid)

    if n_blocks == 1:
        return body(0, init)
    return jax.lax.fori_loop(0, n_blocks, body, init)


@functools.partial(jax.jit, static_argnames=("bins_per_unit", "num_bins", "block"))
def pair_ratio_histogram(
    src: jax.Array,
    dst: jax.Array,
    active: jax.Array | None = None,
    bins_per_unit: int = 20,
    num_bins: int = 200000,
    block: int = 1024,
) -> jax.Array:
    """Exact histogram of ||dst_j - dst_i|| / ||src_j - src_i|| over all
    active pairs i < j. src/dst: (3, C). Returns counts (num_bins,) int32;
    ratios beyond the last bin are clamped into it (registration.cc:714-723
    with a fixed MaxScale)."""

    def tile(counts, v1, v2, valid):
        bins = ratio_bins(v1, v2, bins_per_unit, num_bins)
        return bin_counts(bins, valid, counts)

    return _sweep(src, dst, active, block, tile,
                  jnp.zeros((num_bins,), jnp.int32))


@functools.partial(jax.jit, static_argnames=("block",))
def pair_beta_count(
    src: jax.Array,
    dst: jax.Array,
    beta: jax.Array | float,
    active: jax.Array | None = None,
    block: int = 1024,
) -> jax.Array:
    """Exact count of active pairs i < j passing the known-scale window
    | ||src_j - src_i|| - ||dst_j - dst_i|| | <= beta
    (registration.cc:753-767). src/dst: (3, C). Returns () int32."""

    def tile(count, v1, v2, valid):
        return count + jnp.sum((jnp.abs(v1 - v2) <= beta) & valid, dtype=jnp.int32)

    return _sweep(src, dst, active, block, tile, jnp.int32(0))


@jax.jit
def consistency_degree(
    src: jax.Array,
    dst: jax.Array,
    tau: float | jax.Array,
    active: jax.Array | None = None,
) -> jax.Array:
    """Per-correspondence degree in the length-consistency graph:
    deg[i] = #{active j != i : | ||s_i - s_j|| - ||t_i - t_j|| | < tau},
    0 for inactive i. src/dst: (3, C). Returns (C,) int32."""
    c = src.shape[1]
    if active is None:
        active = jnp.ones((c,), bool)
    src = src.astype(jnp.float32)
    dst = dst.astype(jnp.float32)
    ds, dt = pair_lengths(src, dst, src, dst)
    idx = jnp.arange(c)
    ok = (
        (jnp.abs(ds - dt) < tau)
        & (idx[:, None] != idx[None, :])
        & active[:, None]
        & active[None, :]
    )
    return jnp.sum(ok, axis=1, dtype=jnp.int32)
