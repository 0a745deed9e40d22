"""Golden-file parity against the reference's shipped MATLAB-exported
fixtures (mounted read-only at /root/reference/TEASER-plusplus/test).

Parity targets:
- certification-test.cc:355-586 — every internal DRS matrix per case
  (omega, block-diag omega, Q_cost, lambda guess, A_inv, W_dual,
  suboptimality gap, full certify trajectory) vs
  test/teaser/data/certification_{small,large}_instances/case_*/.
- registration-benchmark.cc:275-375 — decoupled solves on
  test/benchmark/data/benchmark_{1..6}/ vs ground truth AND the MATLAB
  TEASER estimates, within the reference's own ErrorConditions.
- io-test / matcher-test / feature-test — shipped PLY/PCD/CSV fixtures.

All tests skip gracefully when the reference tree is not mounted.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

REF = "/root/reference/TEASER-plusplus/test"
CERT_SMALL = os.path.join(REF, "teaser/data/certification_small_instances")
CERT_LARGE = os.path.join(REF, "teaser/data/certification_large_instances")
BENCH = os.path.join(REF, "benchmark/data")
TDATA = os.path.join(REF, "teaser/data")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference fixture tree not mounted"
)

ACCEPTABLE_ERROR = 1e-7  # certification-test.cc:29


def _csv(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


def _params_txt(path):
    out = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                out[k.strip()] = float(v.strip())
    return out


def load_cert_case(case_dir):
    """Load one certification fixture case (certification-test.cc:134-258)."""
    d = {"params": _params_txt(os.path.join(case_dir, "parameters.txt"))}
    for name in ("v1", "v2", "R_est", "theta_est", "q_est"):
        d[name] = _csv(os.path.join(case_dir, name + ".csv"))
    d["theta_est"] = d["theta_est"].reshape(-1)
    d["q_est"] = d["q_est"].reshape(-1)  # (x, y, z, w) — test.cc:161
    for name in (
        "omega", "block_diag_omega", "Q_cost", "lambda_bar_init", "A_inv",
        "W_1st_iter", "W_dual_1st_iter", "M_affine_1st_iter", "mu",
        "suboptimality_1st_iter", "suboptimality_traj",
    ):
        p = os.path.join(case_dir, name + ".csv")
        if os.path.exists(p):
            d[name] = _csv(p)
    return d


def cert_cases(root):
    if not os.path.isdir(root):
        return []
    return sorted(
        os.path.join(root, c) for c in os.listdir(root)
        if os.path.isdir(os.path.join(root, c))
    )


SMALL_CASES = cert_cases(CERT_SMALL)
LARGE_CASES = cert_cases(CERT_LARGE)


@pytest.fixture(autouse=True)
def _x64():
    # The reference pipeline is Eigen f64; golden comparisons at 1e-7 need
    # f64 end to end.
    with jax.enable_x64(True):
        yield


class TestCertificationGoldens:
    @pytest.mark.parametrize("case_dir", SMALL_CASES)
    def test_omega1(self, case_dir):
        from psulvsb_tpu.certify.drs import get_omega1

        d = load_cert_case(case_dir)
        got = np.asarray(get_omega1(jnp.asarray(d["q_est"])))
        np.testing.assert_allclose(got, d["omega"], atol=ACCEPTABLE_ERROR)

    @pytest.mark.parametrize("case_dir", SMALL_CASES)
    def test_block_diag_omega(self, case_dir):
        from psulvsb_tpu.certify.drs import get_omega1

        d = load_cert_case(case_dir)
        n = d["v1"].shape[1]
        omega = get_omega1(jnp.asarray(d["q_est"]))
        got = np.asarray(jnp.kron(jnp.eye(n + 1, dtype=omega.dtype), omega))
        np.testing.assert_allclose(
            got, d["block_diag_omega"], atol=ACCEPTABLE_ERROR
        )

    @pytest.mark.parametrize("case_dir", SMALL_CASES)
    def test_q_cost(self, case_dir):
        from psulvsb_tpu.certify.drs import get_q_cost

        d = load_cert_case(case_dir)
        got = np.asarray(
            get_q_cost(
                jnp.asarray(d["v1"]), jnp.asarray(d["v2"]),
                d["params"]["noise_bound"], d["params"]["cbar2"],
            )
        )
        # Q entries scale with |v|^2 ~ 1; isApprox default is relative.
        np.testing.assert_allclose(
            got, d["Q_cost"], atol=1e-9 * max(1.0, np.abs(d["Q_cost"]).max())
        )

    @pytest.mark.parametrize("case_dir", SMALL_CASES)
    def test_lambda_guess(self, case_dir):
        from psulvsb_tpu.certify.drs import get_lambda_guess

        d = load_cert_case(case_dir)
        got = np.asarray(
            get_lambda_guess(
                jnp.asarray(d["R_est"]), jnp.asarray(d["theta_est"]),
                jnp.asarray(d["v1"]), jnp.asarray(d["v2"]),
                d["params"]["noise_bound"], d["params"]["cbar2"],
            )
        )
        np.testing.assert_allclose(got, d["lambda_bar_init"], atol=ACCEPTABLE_ERROR)

    @pytest.mark.parametrize("case_dir", SMALL_CASES)
    def test_a_inv_closed_form(self, case_dir):
        """The closed-form A_inv matvec (drs.apply_a_inv) equals the
        reference's sparse matrix (getLinearProjection) applied to random
        vectors, under the lexicographic (i < j) pair ordering
        (certification.cc:552-560)."""
        from psulvsb_tpu.certify.drs import apply_a_inv

        d = load_cert_case(case_dir)
        theta_p = np.concatenate([[1.0], d["theta_est"]])
        k = theta_p.shape[0]
        a_inv = d["A_inv"]
        n_pairs = k * (k - 1) // 2
        assert a_inv.shape == (n_pairs, n_pairs)
        iu = np.triu_indices(k, 1)  # row-major == mat2vec ordering

        rng = np.random.default_rng(0)
        for _ in range(3):
            b = rng.normal(size=n_pairs)
            grid = np.zeros((k, k, 1))
            grid[iu[0], iu[1], 0] = b
            out_grid = np.asarray(
                apply_a_inv(jnp.asarray(grid), jnp.asarray(theta_p))
            )
            got = out_grid[iu[0], iu[1], 0]
            np.testing.assert_allclose(got, a_inv @ b, atol=1e-10)

    @pytest.mark.parametrize("case_dir", SMALL_CASES)
    def test_dual_projection(self, case_dir):
        from psulvsb_tpu.certify.drs import dual_projection

        d = load_cert_case(case_dir)
        theta_p = jnp.asarray(np.concatenate([[1.0], d["theta_est"]]))
        got = np.asarray(
            dual_projection(jnp.asarray(d["W_1st_iter"]), theta_p)
        )
        np.testing.assert_allclose(
            got, d["W_dual_1st_iter"], atol=ACCEPTABLE_ERROR
        )

    @pytest.mark.parametrize("case_dir", SMALL_CASES)
    def test_suboptimality_gap(self, case_dir):
        """computeSubOptimalityGap (certification.cc:192-231) on the fixture's
        M_affine + mu."""
        d = load_cert_case(case_dir)
        m = jnp.asarray(d["M_affine_1st_iter"])
        mu = float(d["mu"][0, 0])
        n = d["v1"].shape[1]
        sym = (m + m.T) / 2
        min_eig = float(jnp.linalg.eigvalsh(sym)[0])
        gap = 0.0 if min_eig > 0 else (-min_eig * (n + 1)) / mu
        expected = float(d["suboptimality_1st_iter"][0, 0])
        assert abs(gap - expected) < ACCEPTABLE_ERROR

    @pytest.mark.parametrize(
        "case_dir", SMALL_CASES + LARGE_CASES,
        ids=lambda p: os.path.relpath(p, REF),
    )
    def test_certify_trajectory(self, case_dir):
        """Full certify vs the MATLAB-exported suboptimality trajectory
        (compareCertificationResult, certification-test.cc:109-130)."""
        from psulvsb_tpu.certify.drs import certify_rotation

        d = load_cert_case(case_dir)
        res = certify_rotation(
            jnp.asarray(d["R_est"]),
            jnp.asarray(d["v1"]),
            jnp.asarray(d["v2"]),
            jnp.asarray(d["theta_est"]),
            noise_bound=d["params"]["noise_bound"],
            cbar2=d["params"]["cbar2"],
            max_iterations=int(d["params"].get("max_iterations", 200)),
        )
        expected_traj = d["suboptimality_traj"].reshape(-1)
        traj = np.asarray(res.suboptimality_traj)
        traj = traj[np.isfinite(traj)]
        assert traj.shape[0] == expected_traj.shape[0], (
            f"iteration count {traj.shape[0]} vs reference {expected_traj.shape[0]}"
        )
        np.testing.assert_allclose(traj, expected_traj, atol=1e-6)
        # best_suboptimality parity (compareCertificationResult:126-129).
        # Note large case_2's own reference trajectory never drops below the
        # 1e-3 certificate threshold, so is_optimal correctly stays False
        # there — only the gap values are compared, as in the reference.
        assert abs(float(res.best_suboptimality) - expected_traj.min()) < 1e-6


def load_benchmark(name):
    from psulvsb_tpu.io.ply import read_ply

    folder = os.path.join(BENCH, name)
    d = _params_txt(os.path.join(folder, "parameters.txt"))
    data = {
        "noise_bound": d["Noise Bound"],
        "src": read_ply(os.path.join(folder, "src.ply"), dtype=np.float64),
        "dst": read_ply(os.path.join(folder, "dst.ply"), dtype=np.float64),
    }
    for nm in ("R_est", "R_ref", "t_est", "t_ref", "s_est", "s_ref"):
        data[nm] = _csv(os.path.join(folder, nm + ".csv"))
    data["t_est"] = data["t_est"].reshape(-1)
    data["t_ref"] = data["t_ref"].reshape(-1)
    data["s_est"] = float(data["s_est"][0, 0])
    data["s_ref"] = float(data["s_ref"][0, 0])
    return data


# (name, (s_gt, R_gt, t_gt, s_matlab, R_matlab, t_matlab)) — the reference's
# own ErrorConditions (registration-benchmark.cc:275-375). R errors are
# geodesic radians, s/t absolute (getAngularError / vector norms).
BENCH_CONDITIONS = [
    ("benchmark_1", (1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5)),
    ("benchmark_2", (1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5)),
    ("benchmark_3", (1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5)),
    ("benchmark_4", (1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5)),
    ("benchmark_5", (1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5)),
    ("benchmark_6", (1e-2, 1e-2, 2e-2, 1e-5, 1e-3, 1e-3)),
]


@pytest.mark.skipif(not os.path.isdir(BENCH), reason="benchmark fixtures absent")
class TestBenchmarkGoldens:
    @pytest.mark.parametrize("name,cond", BENCH_CONDITIONS)
    @pytest.mark.parametrize("rotation_method", ["GNC-TLS", "FGR"])
    def test_decoupled_vs_matlab(self, name, cond, rotation_method):
        """registration-benchmark.cc benchmarkRunner: decoupled solve must
        match BOTH the synthetic ground truth (\\*_ref) and the MATLAB TEASER
        estimates (\\*_est) within ErrorConditions."""
        from psulvsb_tpu.core.metrics import angular_error_rad
        from psulvsb_tpu.solver.classic import solve_decoupled
        from psulvsb_tpu.solver.config import (
            SolverParams,
            RotationEstimationAlgorithm,
        )

        data = load_benchmark(name)
        s_gt_tol, r_gt_tol, t_gt_tol, s_ml_tol, r_ml_tol, t_ml_tol = cond

        params = SolverParams(
            noise_bound=data["noise_bound"],
            cbar2=1.0,
            estimate_scaling=True,
            rotation_estimation_algorithm=(
                RotationEstimationAlgorithm.GNC_TLS
                if rotation_method == "GNC-TLS"
                else RotationEstimationAlgorithm.FGR
            ),
            rotation_max_iterations=100,
            rotation_gnc_factor=1.4,
            rotation_cost_threshold=(
                1e-12 if rotation_method == "GNC-TLS" else 0.005
            ),
            gnc_rot_method="eigh",
            # The MATLAB references come from upstream TEASER's adaptive
            # voting scale estimator, not the fork's 1-pt RANSAC.
            scale_estimator="vote",
        )
        sol, _ = solve_decoupled(
            jnp.asarray(data["src"]), jnp.asarray(data["dst"]), params,
            jax.random.PRNGKey(0),
        )
        s, r, t = float(sol.scale), np.asarray(sol.rotation), np.asarray(sol.translation)

        assert abs(s - data["s_ref"]) <= s_gt_tol
        assert float(angular_error_rad(jnp.asarray(data["R_ref"]), jnp.asarray(r))) <= r_gt_tol
        assert np.linalg.norm(t - data["t_ref"]) <= t_gt_tol

        assert abs(s - data["s_est"]) <= s_ml_tol
        assert float(angular_error_rad(jnp.asarray(data["R_est"]), jnp.asarray(r))) <= r_ml_tol
        assert np.linalg.norm(t - data["t_est"]) <= t_ml_tol


class TestShippedDataFixtures:
    def test_ply_fixtures_readable(self):
        """io-test parity surface: every shipped PLY loads with finite
        coordinates."""
        from psulvsb_tpu.io.ply import read_ply

        for name in (
            "cube.ply", "canstick.ply",
            "matcher-test-object-1.ply", "matcher-test-scene-1.ply",
        ):
            pts = read_ply(os.path.join(TDATA, name))  # (3, N)
            assert pts.shape[0] == 3 and pts.shape[1] > 0
            assert np.isfinite(pts).all()

    @staticmethod
    def _read_pcd_ascii(path):
        pts = []
        with open(path) as f:
            in_data = False
            for line in f:
                if in_data:
                    tok = line.split()
                    if len(tok) >= 3:
                        pts.append([float(tok[0]), float(tok[1]), float(tok[2])])
                elif line.startswith("DATA"):
                    assert "ascii" in line
                    in_data = True
                elif line.startswith("POINTS") or line[0].isdigit() or line[0] == "-":
                    # v.5 PCD may omit DATA line; points follow the header
                    tok = line.split()
                    if len(tok) == 3:
                        try:
                            pts.append([float(t) for t in tok])
                        except ValueError:
                            pass
        return np.asarray(pts)

    def test_fpfh_vs_pcl_golden(self):
        """feature-test.cc:50-100: FPFH-33 on bunny.pcd (normals r=0.03,
        fpfh r=0.05) vs the PCL-exported bunny_fpfh.csv. The batched FPFH uses
        capped-kNN neighborhoods instead of exact radius search, so parity
        is distributional: high per-point cosine similarity of the 33-bin
        histograms, not elementwise equality."""
        from psulvsb_tpu.frontend.fpfh import compute_fpfh
        from psulvsb_tpu.frontend.normals import estimate_normals

        pts = self._read_pcd_ascii(os.path.join(TDATA, "bunny.pcd"))
        assert pts.shape[0] > 0
        ref = np.loadtxt(os.path.join(TDATA, "bunny_fpfh.csv")).reshape(-1, 33)
        assert ref.shape[0] == pts.shape[0]

        p = jnp.asarray(pts.T, jnp.float32)
        normals = estimate_normals(p, k=20)
        got = np.asarray(compute_fpfh(p, normals, 0.05, k=128))

        gn = got / np.maximum(np.linalg.norm(got, axis=1, keepdims=True), 1e-9)
        rn = ref / np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-9)
        cos = np.sum(gn * rn, axis=1)
        assert np.median(cos) > 0.9, f"median descriptor cosine {np.median(cos)}"
        assert np.mean(cos) > 0.85, f"mean descriptor cosine {np.mean(cos)}"

    def test_matcher_self_matching_golden(self):
        """matcher-test.cc SelfMatching: matching canstick.ply against itself
        must map points to themselves. PCL/FLANN gets 100% exactly (distance-0
        self hits win its tie-breaking); duplicate/symmetric descriptors make
        a handful of ties legitimate, so the criterion is >= 95% identity at
        >= 85% coverage."""
        from psulvsb_tpu.io.ply import read_ply
        from psulvsb_tpu.frontend.fpfh import compute_fpfh
        from psulvsb_tpu.frontend.normals import estimate_normals
        from psulvsb_tpu.frontend.matcher import match_features

        can = read_ply(os.path.join(TDATA, "canstick.ply"))
        p = jnp.asarray(can, jnp.float32)
        f = np.asarray(compute_fpfh(p, estimate_normals(p, k=20), 0.05, k=128))
        got = np.asarray(
            match_features(can, can, f, f, use_absolute_scale=False,
                           use_crosscheck=True, use_tuple_test=False)
        )
        assert got.shape[0] >= 0.85 * can.shape[1]
        assert (got[:, 0] == got[:, 1]).mean() >= 0.95

    @pytest.mark.slow
    def test_matcher_case1_structural(self):
        """matcher-test.cc MatchCase1 surface: object/scene PLYs -> FPFH ->
        mutual-NN + cross-check. Exact parity with the shipped
        matcher-test-matches-1.csv is NOT achievable — the CSV records
        PCL+FLANN's specific NN choices over 60k scene points, which a
        different (kNN-normal, capped-neighborhood) FPFH reorders — so this
        checks the pipeline's structural contract on the golden inputs:
        plausible match count, valid indices, cross-check strictness."""
        from psulvsb_tpu.io.ply import read_ply
        from psulvsb_tpu.frontend.fpfh import compute_fpfh
        from psulvsb_tpu.frontend.normals import estimate_normals
        from psulvsb_tpu.frontend.matcher import match_features

        obj = read_ply(os.path.join(TDATA, "matcher-test-object-1.ply"))
        scene = read_ply(os.path.join(TDATA, "matcher-test-scene-1.ply"))
        ref = np.loadtxt(
            os.path.join(TDATA, "matcher-test-matches-1.csv"),
            delimiter=",", dtype=np.int64,
        )

        def feats(cloud):
            p = jnp.asarray(cloud, jnp.float32)
            return np.asarray(compute_fpfh(p, estimate_normals(p, k=20), 0.04, k=128))

        fo, fs = feats(obj), feats(scene)
        got = np.asarray(
            match_features(obj, scene, fo, fs, use_absolute_scale=False,
                           use_crosscheck=True, use_tuple_test=False)
        )
        loose = np.asarray(
            match_features(obj, scene, fo, fs, use_absolute_scale=False,
                           use_crosscheck=False, use_tuple_test=False)
        )
        # Same order of magnitude as the golden 189-of-1000 yield.
        assert 50 <= got.shape[0] <= obj.shape[1]
        assert got[:, 0].max() < obj.shape[1] and got[:, 1].max() < scene.shape[1]
        assert len(np.unique(got[:, 0])) == got.shape[0]  # dedup (matcher.cc:301)
        assert got.shape[0] <= loose.shape[0]  # cross-check only removes
        assert ref.shape[0] == 189  # fixture sanity


REG = os.path.join(TDATA, "registration_test")


def _csv3(path):
    """3-row comma CSV -> (3, N) float64 (test_utils.h readFileToEigenMatrix
    layout of objectIn/sceneIn/translation_test fixtures)."""
    return np.loadtxt(path, delimiter=",", ndmin=2)


class TestRegistrationFixtureGoldens:
    """The registration_test/ fixture CSVs consumed by the reference's
    scale/rotation/translation/registration gtests (scale-solver-test.cc,
    rotation-solver-test.cc:100-135, translation-solver-test.cc:20-115,
    registration-test.cc:230-290)."""

    def test_scale_identity_and_scaled(self, key):
        """ScaleSolverTest.UnknownScale (scale-solver-test.cc:23-70):
        identical TIMs -> scale 1; uniformly scaled TIMs -> that factor."""
        from psulvsb_tpu.robust.scale import solve_scale_tls

        obj = jnp.asarray(_csv3(os.path.join(REG, "objectIn.csv")))
        s, _, _ = solve_scale_tls(obj, obj, 1.0, 1.0, key)
        assert float(s) == pytest.approx(1.0, abs=1e-5)
        factor = 2.7183
        s2, _, _ = solve_scale_tls(obj, obj * factor, 1.0, 1.0, key)
        assert float(s2) == pytest.approx(factor, abs=1e-5)

    def test_fixed_scale_inlier_selector(self):
        """ScaleSolverTest.FixedScale (scale-solver-test.cc:71-110):
        identity -> all inliers; *3 + 10 shift -> all outliers."""
        from psulvsb_tpu.robust.scale import select_scale_inliers

        obj = jnp.asarray(_csv3(os.path.join(REG, "objectIn.csv")))
        s, inl, _ = select_scale_inliers(obj, obj, 1.0, 1.0)
        assert float(s) == 1.0
        assert bool(jnp.all(inl))
        shifted = obj * 3.0 + 10.0
        _, inl2, _ = select_scale_inliers(obj, shifted, 1.0, 1.0)
        assert not bool(jnp.any(inl2))

    def test_fgr_rotation_matlab_reference(self):
        """RotationSolverTest.FGR problem 3 (rotation-solver-test.cc:100-135):
        rotation_only_src.csv under the MATLAB-exported arbitrary rotation,
        noise-free -> FGR recovers it to < 1e-5 angular error."""
        from psulvsb_tpu.rotation.fgr import fgr_rotation
        from psulvsb_tpu.core.metrics import angular_error_rad

        src = jnp.asarray(
            np.loadtxt(os.path.join(REG, "rotation_only_src.csv"),
                       delimiter=",", ndmin=2).T
        )
        expected_r = jnp.asarray([
            [0.997379773225804, -0.019905935977315, -0.069551000516966],
            [0.013777311189888, 0.996068297974922, -0.087510750572249],
            [0.071019530105605, 0.086323226782879, 0.993732623426126],
        ])
        dst = expected_r @ src
        res = fgr_rotation(src, dst, 0.025, max_iterations=1,
                           gnc_factor=1.4, cost_threshold=1e-3)
        assert float(angular_error_rad(expected_r, res.rotation)) < 1e-5

    def test_gnc_rotation_identity_fixture(self):
        """RotationSolverTest.GNCTLS problem 1 shape (identity) on the
        shipped fixture points (rotation-solver-test.cc:137-160)."""
        from psulvsb_tpu.rotation.gnc import gnc_tls_rotation
        from psulvsb_tpu.core.metrics import angular_error_rad

        src = jnp.asarray(
            np.loadtxt(os.path.join(REG, "rotation_only_src.csv"),
                       delimiter=",", ndmin=2).T
        )
        res = gnc_tls_rotation(src, src, 1e-12, max_iterations=100,
                               gnc_factor=1.4, cost_threshold=1e-3)
        assert float(angular_error_rad(jnp.eye(3), res.rotation)) < 1e-5

    def test_translation_zero_axis_and_matlab(self):
        """TranslationTest.TLSTranslation (translation-solver-test.cc:20-115):
        zero translation, unit axis translations, and the MATLAB-exported
        arbitrary translation between the v1/v2 inlier fixtures."""
        from psulvsb_tpu.robust.translation import solve_translation

        v1 = jnp.asarray(_csv3(os.path.join(REG, "translation_test_v1_inliers.csv")))
        v2 = jnp.asarray(_csv3(os.path.join(REG, "translation_test_v2_inliers.csv")))

        t, _, _ = solve_translation(v1, v1, 0.025, 1.0)
        np.testing.assert_allclose(np.asarray(t), np.zeros(3), atol=1e-5)

        for axis in range(3):
            shifted = v1.at[axis].add(1.0)
            t, _, _ = solve_translation(v1, shifted, 0.025, 1.0)
            want = np.zeros(3)
            want[axis] = 1.0
            np.testing.assert_allclose(np.asarray(t), want, atol=1e-5)

        # The MATLAB expectations are for UPSTREAM's tiled-TLS estimator;
        # the fork replaced it with max-interval stabbing (the reference's
        # own gtest now exercises the stabbing path and drifts the same
        # ~5e-4 on x — SURVEY.md §4). Assert exact parity on the upstream
        # estimator and fork-typical closeness on the stabbing solve.
        from psulvsb_tpu.robust.scalar_tls import tls_vote

        want = np.array([-0.098430131086161, 0.008679113091532, 0.197317864174211])
        raw = v2 - v1
        nb = 0.00673642835
        for axis in range(3):
            est, _ = tls_vote(raw[axis], jnp.full(raw.shape[1], nb))
            assert float(est) == pytest.approx(want[axis], abs=1e-9)

        t, _, _ = solve_translation(v1, v2, nb, 1.0)
        np.testing.assert_allclose(np.asarray(t), want, atol=5e-4)

    def test_fixed_scale_registration_fgr(self, key):
        """Registration problem 2 (registration-test.cc:230-290): the fork's
        solve() on objectIn/sceneIn with FGR at noise_bound 0.0067364 vs the
        MATLAB reference transform, within the reference's own tolerances
        (0.25 rad rotation, 0.15 translation)."""
        from psulvsb_tpu.solver.config import SolverParams, RotationEstimationAlgorithm
        from psulvsb_tpu.solver.psulvsb import psulvsb_solve
        from psulvsb_tpu.core.metrics import angular_error_rad
        import contextlib

        # The class-wide x64 fixture promotes int literals to int64, which
        # breaks the solver's int32 loop carries; this test's tolerances
        # (0.25 rad / 0.15) don't need f64.
        stack = contextlib.ExitStack()
        stack.enter_context(jax.enable_x64(False))
        self._stack = stack

        obj = jnp.asarray(_csv3(os.path.join(REG, "objectIn.csv")), jnp.float32)
        scene = jnp.asarray(_csv3(os.path.join(REG, "sceneIn.csv")), jnp.float32)
        params = SolverParams.preset_3dmatch(
            noise_bound=0.0067364, noise_bound_dataset=0.0067364,
            estimate_scaling=False,
            rotation_estimation_algorithm=RotationEstimationAlgorithm.FGR,
            sampled_cap=1024, basic_cap=512, hypothesis_batch=8,
        )
        keep = jnp.ones((obj.shape[1],), jnp.int32)
        sol, _ = psulvsb_solve(obj, scene, keep, params, key)
        expected_r = jnp.asarray([
            [0.9974, -0.0199, -0.0696],
            [0.0138, 0.9961, -0.0875],
            [0.0710, 0.0863, 0.9937],
        ], jnp.float32)
        expected_t = np.array([-0.1011, 0.0908, 0.1344])
        try:
            assert float(angular_error_rad(expected_r, sol.rotation)) <= 0.25
            assert (
                float(np.linalg.norm(np.asarray(sol.translation) - expected_t))
                <= 0.15
            )
        finally:
            stack.close()


class TestScaleAndLargeModelFixtures:
    def test_solve_for_scale_matlab_ref(self, key):
        """RegistrationTest.SolveForScale (registration-test.cc:62-100):
        complete-graph TIMs of objectIn/sceneIn -> TLS scale 0.955885
        within 0.01 (the MATLAB reference value)."""
        from psulvsb_tpu.pairs.tims import compute_tims
        from psulvsb_tpu.robust.scale import solve_scale_tls

        obj = jnp.asarray(_csv3(os.path.join(REG, "objectIn.csv")))
        scene = jnp.asarray(_csv3(os.path.join(REG, "sceneIn.csv")))
        src_tims, _, _, _ = compute_tims(obj)
        dst_tims, _, _, _ = compute_tims(scene)
        s, _, _ = solve_scale_tls(src_tims, dst_tims, 0.0067364, 1.0, key)
        assert float(s) == pytest.approx(0.955885, abs=0.01)

    def test_large_model_solve(self, key):
        """RegistrationTest.LargeModel (registration-test.cc:20-60): the
        shipped 1000-point model/scene PLYs solve to a valid registration
        with FGR at noise_bound 0.0337 (the reference asserts only
        completion; we additionally require validity and finite outputs)."""
        from psulvsb_tpu.io.ply import read_ply
        from psulvsb_tpu.solver.config import SolverParams, RotationEstimationAlgorithm
        from psulvsb_tpu.solver.psulvsb import psulvsb_solve

        with jax.enable_x64(False):
            src = jnp.asarray(
                read_ply(os.path.join(REG, "1000point_model.ply")), jnp.float32
            )
            dst = jnp.asarray(
                read_ply(os.path.join(REG, "1000point_scene.ply")), jnp.float32
            )
            params = SolverParams.preset_3dmatch(
                noise_bound=0.0337, noise_bound_dataset=0.0337,
                estimate_scaling=False,
                rotation_estimation_algorithm=RotationEstimationAlgorithm.FGR,
                sampled_cap=1024, basic_cap=512, hypothesis_batch=8,
            )
            keep = jnp.ones((src.shape[1],), jnp.int32)
            sol, _ = psulvsb_solve(src, dst, keep, params, key)
            assert bool(sol.valid)
            assert bool(jnp.all(jnp.isfinite(sol.rotation)))
            assert bool(jnp.all(jnp.isfinite(sol.translation)))
