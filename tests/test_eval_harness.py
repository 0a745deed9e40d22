"""Experiment harness tests: synthetic protocol CSVs, real-data driver on
generated fixture files, correspondence generator, voxel/ISS frontend."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from psulvsb_tpu.eval.synthetic import synthetic_cloud, make_synthetic_pair
from psulvsb_tpu.eval.protocol import run_protocol, run_trial
from psulvsb_tpu.eval import realdata
from psulvsb_tpu.eval.corr_gen import generate_correspondences, write_corr_file
from psulvsb_tpu.frontend.voxel import voxel_downsample
from psulvsb_tpu.frontend.iss import iss_keypoints
from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.core.se3 import random_se3, transform_points


SMALL = dict(sampled_cap=512, basic_cap=256, hypothesis_batch=4, scale_max_draws=64)


class TestVoxelIss:
    def test_voxel_downsample_merges(self):
        pts = np.array(
            [[0.0, 0.01, 1.0, 1.02], [0.0, 0.01, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]
        )
        out = voxel_downsample(pts, 0.5)
        assert out.shape[1] == 2
        assert sorted(np.round(out[0], 3).tolist()) == [0.005, 1.01]

    def test_iss_finds_corners(self):
        """Flat plane + one protruding spike: the spike region is salient."""
        rng = np.random.default_rng(0)
        xy = rng.uniform(-1, 1, size=(2, 400)).astype(np.float32)
        plane = np.vstack([xy, np.zeros((1, 400), np.float32)])
        pts = jnp.asarray(plane)
        mask = np.asarray(
            iss_keypoints(pts, salient_radius=0.3, non_max_radius=0.2, k=48)
        )
        # A pure plane has lambda3 = 0 everywhere -> no keypoints.
        assert mask.sum() == 0


class TestSyntheticProtocol:
    def test_run_trial(self, key):
        src = jnp.asarray(synthetic_cloud(120, seed=0))
        params = SolverParams.preset_artificial(**SMALL)
        r = run_trial(key, src, params, noise_bound=0.05, outlier_rate=0.8)
        assert r.angle_error_deg < 10.0
        assert r.trans_error < 0.5

    def test_protocol_writes_csvs(self, tmp_path):
        clouds = {"blob": synthetic_cloud(100, seed=1)}
        params = SolverParams.preset_artificial(**SMALL)
        agg = run_protocol(
            clouds, params, str(tmp_path), trials=2, outlier_rate=0.7
        )
        assert os.path.exists(tmp_path / "blob.csv")
        assert os.path.exists(tmp_path / "Average.csv")
        assert "angle_error_deg" in agg["blob"]
        mean, std = agg["blob"]["angle_error_deg"]
        assert mean < 15.0


class TestRealDataHarness:
    def _make_fixture(self, tmp_path, key, n=150):
        """Generate a 3DMatch-layout scene directory with 2 pairs."""
        scene = tmp_path / "test-scene"
        scene.mkdir()
        pair_ids = [(0, 1), (1, 2)]
        for a, b in pair_ids:
            src = jnp.asarray(synthetic_cloud(n, seed=a * 10 + b))
            k = jax.random.fold_in(key, a * 7 + b)
            pair = make_synthetic_pair(k, src, noise_bound=0.01, outlier_rate=0.6)
            stem = scene / f"cloud_bin_{a}+cloud_bin_{b}"
            write_corr_file(str(stem) + "@corr.txt", pair.src, pair.dst)
            gt = np.asarray(pair.transform.as_matrix())
            np.savetxt(str(stem) + "@GTmat.txt", gt)
        with open(scene / "pairs.txt", "w") as f:
            for a, b in pair_ids:
                f.write(f"{a} {b}\n")
        return scene

    def test_scene_recall(self, tmp_path, key):
        scene = self._make_fixture(tmp_path, key)
        params = SolverParams.preset_artificial(
            noise_bound_dataset=0.05, **SMALL
        )
        stats = realdata.run_scene(
            str(scene),
            str(scene / "pairs.txt"),
            params,
            realdata.SuccessCriteria.threedmatch(),
            str(tmp_path / "out.csv"),
            ddtime=1,
        )
        assert stats["pairs"] == 2
        assert stats["recall"] == 1.0, stats
        assert os.path.exists(tmp_path / "out.csv")

    def test_corr_file_roundtrip(self, tmp_path, rng):
        src = rng.normal(size=(3, 20))
        dst = rng.normal(size=(3, 20))
        p = str(tmp_path / "c.txt")
        write_corr_file(p, src, dst)
        s2, d2 = realdata.read_corr_file(p)
        np.testing.assert_allclose(s2, src, atol=1e-6)
        np.testing.assert_allclose(d2, dst, atol=1e-6)


class TestCorrGen:
    def test_generates_consistent_pairs(self, key):
        src_cloud = np.asarray(synthetic_cloud(600, seed=3))
        t = random_se3(key, max_translation=0.5)
        dst_cloud = np.asarray(transform_points(t, jnp.asarray(src_cloud)))
        src_kp, dst_m = generate_correspondences(src_cloud, dst_cloud, noise_bound=0.05)
        assert src_kp.shape == dst_m.shape
        if src_kp.shape[1] >= 5:
            # A decent fraction of matches should agree with the transform.
            moved = np.asarray(transform_points(t, jnp.asarray(src_kp)))
            err = np.linalg.norm(moved - dst_m, axis=0)
            assert (err < 0.2).mean() > 0.3, err


class TestGtLog:
    def test_read_gt_log(self, tmp_path, rng):
        from psulvsb_tpu.eval.realdata import read_gt_log

        p = tmp_path / "gt.log"
        m1 = np.round(rng.normal(size=(4, 4)), 4)
        m2 = np.round(rng.normal(size=(4, 4)), 4)
        with open(p, "w") as f:
            f.write("0 1 60\n")
            for row in m1:
                f.write(" ".join(str(v) for v in row) + "\n")
            f.write("2 5 60\n")
            for row in m2:
                f.write(" ".join(str(v) for v in row) + "\n")
        out = read_gt_log(str(p))
        assert set(out) == {(0, 1), (2, 5)}
        np.testing.assert_allclose(out[(0, 1)], m1)
        np.testing.assert_allclose(out[(2, 5)], m2)


class TestMismatchOutliers:
    def test_mismatch_pair_solves_with_prefilter(self, key):
        """Realistic correspondence outliers (wrong matches between real
        surface points): the normal-angle pre-filter must keep enough true
        inliers for the full pipeline to succeed."""
        from psulvsb_tpu.eval.pipeline import solve_with_prefilter
        from psulvsb_tpu.core.metrics import angular_error_deg

        src = jnp.asarray(synthetic_cloud(300, seed=20))
        pair = make_synthetic_pair(key, src, noise_bound=0.01, outlier_rate=0.8,
                                   outlier_mode="mismatch")
        params = SolverParams.preset_3dmatch(
            estimate_scaling=False, noise_bound=0.05, **SMALL
        )
        res = solve_with_prefilter(pair.src, pair.dst, params, jax.random.PRNGKey(4))
        re = float(angular_error_deg(pair.transform.rotation, res.solution.rotation))
        assert re < 5.0, re


class TestPrefilterFallback:
    def test_evaluate_pair_last_retry_unfiltered(self, key):
        """ddtime >= 2: the final retry runs without the pre-filter, so a
        pair whose inliers the filter discards still registers."""
        src = jnp.asarray(synthetic_cloud(200, seed=30))
        pair = make_synthetic_pair(key, src, noise_bound=0.01, outlier_rate=0.7,
                                   outlier_mode="mismatch")
        gt = np.asarray(pair.transform.as_matrix())
        params = SolverParams.preset_3dmatch(
            estimate_scaling=False, noise_bound=0.05, **SMALL
        )
        r = realdata.evaluate_pair(
            np.asarray(pair.src), np.asarray(pair.dst), gt, params,
            realdata.SuccessCriteria.threedmatch(), jax.random.PRNGKey(1),
            ddtime=2,
        )
        assert r.success, r


class TestDecoupledFallback:
    @pytest.mark.slow
    def test_rescues_hostile_pair(self, key):
        """evaluate_pair(decoupled_fallback=True): the classic clique path
        must rescue a >= 97%-outlier pair where the PSULVSB retries plateau
        (the clique prunes before rotation; registration.cc:986-991 feeds
        GNC everything at known scale)."""
        n = 600
        src_c = jnp.asarray(synthetic_cloud(n, seed=9))
        pair = make_synthetic_pair(
            key, src_c, noise_bound=0.01, outlier_rate=0.97,
            outlier_mode="mismatch",
        )
        gt = np.eye(4)
        gt[:3, :3] = np.asarray(pair.transform.rotation)
        gt[:3, 3] = np.asarray(pair.transform.translation)
        params = SolverParams.preset_3dmatch(
            sampled_cap=1024, basic_cap=512, hypothesis_batch=8
        )
        crit = realdata.SuccessCriteria.threedmatch()
        r = realdata.evaluate_pair(
            np.asarray(pair.src), np.asarray(pair.dst), gt, params, crit,
            jax.random.PRNGKey(3), ddtime=2, decoupled_fallback=True,
        )
        assert r.angle_error_deg < 15.0
        assert r.trans_error < 0.3


class TestNanSafeBestOf:
    """A collapsed retry (e.g. the prefilter discarding nearly every point)
    yields NaN RMSE; float('nan') comparisons are all False, so the naive
    `r.rmse < best.rmse` rule froze a retry-0 NaN as the running best and
    masked every later good retry (r4: the unknown-scale protocol's one
    residual failure — 180 deg / NaN across all 10 retries of a pair whose
    unfiltered fallback retry solves it cleanly)."""

    def _res(self, rmse):
        return realdata.PairResult(
            scale_error=0.0, angle_error_deg=0.0, trans_error=0.0,
            rmse=rmse, time_s=0.0, success=False,
        )

    def test_rmse_key_orders_nan_last(self):
        import math

        rs = [self._res(float("nan")), self._res(0.5), self._res(0.1)]
        best = None
        for r in rs:
            if best is None or realdata._rmse_key(r) < realdata._rmse_key(best):
                best = r
        assert best.rmse == 0.1
        assert math.isinf(realdata._rmse_key(self._res(float("nan"))))

    def test_batch_harness_shares_key(self):
        from psulvsb_tpu.eval import batch_harness

        assert batch_harness._rmse_key(self._res(float("nan"))) == float("inf")
        assert batch_harness._rmse_key(self._res(2.0)) == 2.0

    def test_nan_rmse_triggers_decoupled_fallback(self, key):
        """evaluate_pair's fallback gate must treat a NaN best RMSE as
        'clearly failed' (NaN > thr is False — the old gate skipped the
        rescue exactly when it was needed most)."""
        import math

        assert not (float("nan") > 5.0 * 0.01)  # the old gate's blind spot
        # The fixed gate: `not (best.rmse <= thr)` fires on NaN.
        assert not (float("nan") <= 5.0 * 0.01)
