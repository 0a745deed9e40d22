"""Exact pair-grid ratio histogram and beta-window count
(ops/pair_grid.py) and the scatter-free sort utilities feeding the init
stage (pairs/tims.py).

Parity targets: the XLA exact sweep's histogram geometry
(registration.cc:687-729 semantics via pairs/tims.py) and the reduced-set
construction of solver/psulvsb.py::_init_stage."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from psulvsb_tpu.ops.pair_grid import pair_beta_count, pair_ratio_histogram
from psulvsb_tpu.pairs.tims import (
    triu_pair_indices,
    ratio_bin_indices,
    sort_peak_bin,
    masked_random_compact,
)


def _xla_reference(src, dst, active, bins_per_unit, num_bins):
    c = src.shape[1]
    ii, jj = triu_pair_indices(c)
    ii, jj = jnp.asarray(ii), jnp.asarray(jj)
    st = src[:, jj] - src[:, ii]
    dt = dst[:, jj] - dst[:, ii]
    v1 = jnp.sqrt(jnp.sum(st * st, axis=0))
    v2 = jnp.sqrt(jnp.sum(dt * dt, axis=0))
    ratios = v2 / jnp.where(v1 > 0, v1, 1.0)
    pa = active[ii] & active[jj]
    idx = jnp.clip(
        jnp.floor(ratios * bins_per_unit).astype(jnp.int32), 0, num_bins - 1
    )
    counts = jnp.zeros((num_bins,), jnp.int32).at[idx].add(pa.astype(jnp.int32))
    return counts, idx, pa


class TestPairRatioHistogram:
    def test_matches_xla_sweep(self, rng):
        """Counts match the gather-based sweep over row tiles that do not
        divide C (both take direct differences; tolerance 2 per bin for
        last-bit rounding of razor-edge ratios; the peak exactly)."""
        c = 200
        src = jnp.asarray(rng.normal(size=(3, c)), jnp.float32)
        dst = jnp.asarray(rng.normal(size=(3, c)) * 2.0, jnp.float32)
        active = jnp.asarray(rng.uniform(size=c) < 0.8)
        counts = pair_ratio_histogram(src, dst, active, num_bins=512, block=64)
        ref, _, _ = _xla_reference(src, dst, active, 20, 512)
        assert int(counts.sum()) == int(ref.sum())  # every pair votes once
        np.testing.assert_allclose(np.asarray(counts), np.asarray(ref), atol=2)
        assert int(jnp.argmax(counts)) == int(jnp.argmax(ref))

    def test_inactive_padding_never_votes(self, rng):
        c = 100
        src = jnp.asarray(rng.normal(size=(3, c)), jnp.float32)
        dst = jnp.asarray(rng.normal(size=(3, c)), jnp.float32)
        active = jnp.arange(c) < 60
        counts = pair_ratio_histogram(src, dst, active, num_bins=256, block=32)
        assert int(counts.sum()) == 60 * 59 // 2


class TestSortUtilities:
    def test_sort_peak_matches_histogram_argmax(self, rng):
        idx = jnp.asarray(rng.integers(0, 1000, size=20000), jnp.int32)
        active = jnp.asarray(rng.uniform(size=20000) < 0.7)
        peak, cnt = sort_peak_bin(idx, active, 1000)
        ref = np.bincount(
            np.asarray(idx)[np.asarray(active)], minlength=1000
        )
        assert int(cnt) == int(ref.max())
        assert int(ref[int(peak)]) == int(ref.max())

    def test_sort_peak_all_inactive(self):
        idx = jnp.zeros((64,), jnp.int32)
        peak, cnt = sort_peak_bin(idx, jnp.zeros((64,), bool), 10)
        assert int(cnt) == 0

    def test_masked_compact_uniform_and_complete(self, rng, key):
        n = 5000
        mask = jnp.asarray(rng.uniform(size=n) < 0.3)
        idx_i = jnp.asarray(rng.integers(0, 3000, size=n), jnp.int32)
        idx_j = jnp.asarray(rng.integers(0, 3000, size=n), jnp.int32)
        cap = 8192
        ri, rj, cnt = masked_random_compact(
            key, mask, idx_i, idx_j, cap, max_index=3000
        )  # packed (2-operand) path
        m = int(mask.sum())
        assert int(cnt) == m  # under cap: every member kept
        got = set(zip(np.asarray(ri)[:m].tolist(), np.asarray(rj)[:m].tolist()))
        want = set(
            zip(
                np.asarray(idx_i)[np.asarray(mask)].tolist(),
                np.asarray(idx_j)[np.asarray(mask)].tolist(),
            )
        )
        assert got == want

    def test_masked_compact_over_cap(self, rng, key):
        n = 4096
        mask = jnp.ones((n,), bool)
        idx_i = jnp.arange(n, dtype=jnp.int32)
        idx_j = jnp.arange(n, dtype=jnp.int32) + 1
        # default max_index: the 3-operand (large-domain) path
        ri, rj, cnt = masked_random_compact(key, mask, idx_i, idx_j, 256)
        assert int(cnt) == 256
        # Decimation is a subset of the members, no duplicates.
        vals = np.asarray(ri)[:256]
        assert len(set(vals.tolist())) == 256
        np.testing.assert_array_equal(np.asarray(rj)[:256], vals + 1)


class TestExactHistInit:
    @pytest.mark.slow
    def test_exact_hist_equivalent_solve(self):
        """Full solve with init_mode=exact_hist lands the same registration
        quality as the exact sweep on a scaled clustered-ratio problem."""
        from psulvsb_tpu.eval.synthetic import synthetic_cloud, make_synthetic_pair
        from psulvsb_tpu.solver.config import SolverParams
        from psulvsb_tpu.solver.psulvsb import psulvsb_solve
        from psulvsb_tpu.core.metrics import angular_error_deg

        src = jnp.asarray(synthetic_cloud(300, seed=4))
        pair = make_synthetic_pair(
            jax.random.PRNGKey(3), src, noise_bound=0.01, outlier_rate=0.7,
            outlier_mode="mismatch",
        )
        keep = jnp.ones((300,), jnp.int32)
        for mode in ("exact", "exact_hist"):
            p = SolverParams.preset_3dmatch(
                estimate_scaling=True, init_mode=mode,
                sampled_cap=512, basic_cap=256, hypothesis_batch=4,
                scale_max_draws=64,
            )
            sol, _ = psulvsb_solve(pair.src, pair.dst, keep, p, jax.random.PRNGKey(2))
            re = float(angular_error_deg(pair.transform.rotation, sol.rotation))
            assert re < 5.0, f"{mode}: {re}"
            assert abs(float(sol.scale) - 1.0) < 0.1

    def test_exact_hist_fallback_on_heavy_tail(self):
        """Displace-protocol tails put heavy mass far out in the ratio
        range; the full-range exact histogram must still find the inlier
        peak and the stage still solve."""
        from psulvsb_tpu.eval.synthetic import synthetic_cloud, make_synthetic_pair
        from psulvsb_tpu.solver.config import SolverParams
        from psulvsb_tpu.solver.psulvsb import psulvsb_solve
        from psulvsb_tpu.core.metrics import angular_error_deg

        src = jnp.asarray(synthetic_cloud(300, seed=4))
        pair = make_synthetic_pair(
            jax.random.PRNGKey(3), src, noise_bound=0.05, outlier_rate=0.9,
            outlier_mode="displace",
        )
        keep = jnp.ones((300,), jnp.int32)
        p = SolverParams.preset_artificial(
            estimate_scaling=True, init_mode="exact_hist",
            sampled_cap=512, basic_cap=256, hypothesis_batch=4,
            scale_max_draws=64,
        )
        sol, _ = psulvsb_solve(pair.src, pair.dst, keep, p, jax.random.PRNGKey(2))
        re = float(angular_error_deg(pair.transform.rotation, sol.rotation))
        assert re < 5.0, re


class TestDenseInit:
    """init_mode='dense' (pair-grid lengths + hashed approx_max_k
    compaction) against the gather-based exact sweep."""

    def _sets(self, src, dst, keep, mode, estimate_scaling, key):
        from psulvsb_tpu.solver.config import SolverParams
        from psulvsb_tpu.solver.psulvsb import _init_stage

        p = SolverParams.preset_3dmatch(
            estimate_scaling=estimate_scaling, init_mode=mode,
            noise_bound=0.05, noise_bound_dataset=0.05,
        )
        ri, rj, rc, pool = _init_stage(src, dst, keep, p, key)
        n = int(pool)
        return set(
            zip(np.asarray(ri)[:n].tolist(), np.asarray(rj)[:n].tolist())
        ), int(rc)

    @pytest.mark.parametrize("estimate_scaling", [False, True])
    def test_membership_matches_exact(self, rng, key, estimate_scaling):
        """On CPU approx_max_k lowers to exact top_k, so under the cap the
        dense reduced set must equal the exact sweep's (up to razor-edge
        pairs rounded differently — the fixture keeps the scale mid-bin and
        the noise well inside the window to avoid them)."""
        c = 250
        src = jnp.asarray(rng.normal(size=(3, c)), jnp.float32)
        scale = 1.53 if estimate_scaling else 1.0
        dst = scale * src + jnp.asarray(rng.normal(size=(3, c)) * 0.004, jnp.float32)
        bad = rng.uniform(size=c) < 0.5
        dst = jnp.where(jnp.asarray(bad)[None, :],
                        jnp.asarray(rng.normal(size=(3, c)) * 2.0, jnp.float32), dst)
        keep = jnp.ones((c,), jnp.int32)

        got, rc_d = self._sets(src, dst, keep, "dense", estimate_scaling, key)
        want, rc_e = self._sets(src, dst, keep, "exact", estimate_scaling, key)
        # Identical membership; tolerate <=2 boundary pairs flipped by
        # last-bit rounding.
        assert len(got.symmetric_difference(want)) <= 2, (
            len(got), len(want), len(got.symmetric_difference(want)))
        assert abs(rc_d - rc_e) <= 2

    def test_inactive_points_excluded(self, rng, key):
        c = 200
        src = jnp.asarray(rng.normal(size=(3, c)), jnp.float32)
        dst = src + jnp.asarray(rng.normal(size=(3, c)) * 0.004, jnp.float32)
        keep = jnp.asarray((rng.uniform(size=c) < 0.6).astype(np.int32))
        got, _ = self._sets(src, dst, keep, "dense", False, key)
        dead = set(np.flatnonzero(np.asarray(keep) != 1).tolist())
        for i, j in got:
            assert i not in dead and j not in dead and i < j


class TestCertificateGuards:
    def test_dense_init_out_of_window_scale_still_solves(self):
        """End-to-end: init_mode='dense' with a large scale ratio (150)
        must find the exact peak over the full histogram range and
        register (estimate_scaling)."""
        from psulvsb_tpu.eval.synthetic import synthetic_cloud, make_synthetic_pair
        from psulvsb_tpu.solver.config import SolverParams
        from psulvsb_tpu.solver.psulvsb import psulvsb_solve
        from psulvsb_tpu.core.metrics import angular_error_deg

        n = 250
        src = jnp.asarray(synthetic_cloud(n, seed=5))
        pair = make_synthetic_pair(
            jax.random.PRNGKey(4), src, noise_bound=0.01, outlier_rate=0.6,
            outlier_mode="mismatch",
        )
        scale = 150.0
        dst = pair.dst * scale
        keep = jnp.ones((n,), jnp.int32)
        p = SolverParams.preset_3dmatch(
            estimate_scaling=True, init_mode="dense",
            sampled_cap=512, basic_cap=256, hypothesis_batch=4,
            scale_max_draws=64,
        )
        sol, _ = psulvsb_solve(pair.src, dst, keep, p, jax.random.PRNGKey(6))
        re = float(angular_error_deg(pair.transform.rotation, sol.rotation))
        assert re < 5.0, re
        assert abs(float(sol.scale) / scale - 1.0) < 0.1


class TestPairBetaCount:
    """Known-scale beta-window count (pair_beta_count: exact |reduced|
    beyond dense_init_max_c)."""

    def test_matches_direct_sweep(self):
        n = 160
        rng = np.random.default_rng(3)
        src = jnp.asarray(rng.normal(size=(3, n)).astype(np.float32))
        r = jnp.asarray(
            np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        )
        dst = r @ src + 0.005 * jnp.asarray(
            rng.normal(size=(3, n)).astype(np.float32)
        )
        # Corrupt half the correspondences.
        dst = dst.at[:, n // 2:].set(
            jnp.asarray(rng.normal(size=(3, n - n // 2)).astype(np.float32))
        )
        active = jnp.asarray(rng.random(n) > 0.1)
        beta = 0.02

        iu, ju = np.triu_indices(n, 1)
        v1 = np.linalg.norm(np.asarray(src)[:, ju] - np.asarray(src)[:, iu], axis=0)
        v2 = np.linalg.norm(np.asarray(dst)[:, ju] - np.asarray(dst)[:, iu], axis=0)
        act = np.asarray(active)
        expected = int(
            np.sum((np.abs(v1 - v2) <= beta) & act[iu] & act[ju])
        )
        got = int(pair_beta_count(src, dst, beta, active, block=32))
        # float32 vs float64 rounding can flip razor-edge memberships; on
        # this fixture the boundary density is ~0.1%.
        assert abs(got - expected) <= max(2, expected // 200), (got, expected)

    def test_init_stage_exact_beta_count(self):
        """_init_stage(init_mode='exact_beta') returns the exact known-scale
        |reduced| where the sampled mode only estimates it."""
        from psulvsb_tpu.eval.synthetic import synthetic_cloud, make_synthetic_pair
        from psulvsb_tpu.solver.config import SolverParams
        from psulvsb_tpu.solver.psulvsb import _init_stage

        n = 192
        src = jnp.asarray(synthetic_cloud(n, seed=2))
        pair = make_synthetic_pair(
            jax.random.PRNGKey(1), src, noise_bound=0.01, outlier_rate=0.8,
            outlier_mode="mismatch",
        )
        keep = jnp.ones((n,), jnp.int32)
        p_beta = SolverParams.preset_3dmatch(
            estimate_scaling=False, init_mode="exact_beta"
        )
        p_exact = SolverParams.preset_3dmatch(
            estimate_scaling=False, init_mode="exact"
        )
        _, _, cnt_beta, pool_beta = _init_stage(
            pair.src, pair.dst, keep, p_beta, jax.random.PRNGKey(0)
        )
        _, _, cnt_exact, _ = _init_stage(
            pair.src, pair.dst, keep, p_exact, jax.random.PRNGKey(0)
        )
        assert abs(int(cnt_beta) - int(cnt_exact)) <= max(2, int(cnt_exact) // 200)
        assert int(pool_beta) > 0
