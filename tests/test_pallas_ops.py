"""GROR's consistency degree (ops/pair_grid.py) and the whole-GNC Pallas
kernel (ops/pallas_gnc.py, Triton route; interpret mode here, compiled on
the card by chip_smoke.py and the gpu-marked tests)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from psulvsb_tpu.ops.pair_grid import consistency_degree


def ref_degree(src, dst, tau, active=None):
    c = src.shape[1]
    ds = np.linalg.norm(src[:, :, None] - src[:, None, :], axis=0)
    dt = np.linalg.norm(dst[:, :, None] - dst[:, None, :], axis=0)
    ok = np.abs(ds - dt) < tau
    np.fill_diagonal(ok, False)
    if active is not None:
        ok &= active[None, :] & active[:, None]
        return np.where(active, ok.sum(1), 0)
    return ok.sum(1)


class TestConsistencyDegree:
    @pytest.mark.parametrize("c", [64, 300, 517])
    def test_matches_dense_reference(self, rng, c):
        src = rng.normal(size=(3, c)).astype(np.float32)
        dst = rng.normal(size=(3, c)).astype(np.float32)
        # Half the pairs get consistent geometry.
        dst[:, : c // 2] = src[:, : c // 2] + 0.3
        deg = np.asarray(consistency_degree(jnp.asarray(src), jnp.asarray(dst), 0.05))
        ref = ref_degree(src, dst, 0.05)
        np.testing.assert_array_equal(deg, ref)

    def test_active_mask(self, rng):
        c = 128
        src = rng.normal(size=(3, c)).astype(np.float32)
        dst = (src + 0.1).astype(np.float32)
        active = np.zeros(c, bool)
        active[: c // 2] = True
        deg = np.asarray(
            consistency_degree(
                jnp.asarray(src), jnp.asarray(dst), 0.05, active=jnp.asarray(active)
            )
        )
        ref = ref_degree(src, dst, 0.05, active)
        np.testing.assert_array_equal(deg[: c // 2], ref[: c // 2])
        assert (deg[c // 2 :] == 0).all()


class TestPallasGnc:
    def _problem(self, rng, b=4, n=128, outliers=0.3):
        from tests.test_core import random_rotation

        srcs, dsts, rots = [], [], []
        for i in range(b):
            r = random_rotation(rng)
            src = rng.normal(size=(3, n)).astype(np.float32)
            dst = (r @ src).astype(np.float32)
            k = int(n * outliers)
            dst[:, :k] += rng.normal(size=(3, k)).astype(np.float32) * 2.0
            srcs.append(src); dsts.append(dst); rots.append(r)
        return np.stack(srcs), np.stack(dsts), rots

    def test_matches_xla_gnc(self, rng):
        from psulvsb_tpu.ops.pallas_gnc import gnc_batch
        from psulvsb_tpu.rotation.gnc import gnc_tls_rotation

        b, n = 4, 128
        src_b, dst_b, rots = self._problem(rng, b, n)
        act = np.ones((b, n), bool)
        nb = np.full((b,), 0.1, np.float32)
        rot_p, inl_p = gnc_batch(
            jnp.asarray(src_b), jnp.asarray(dst_b), jnp.asarray(act),
            jnp.asarray(nb), jnp.eye(3, dtype=jnp.float32),
            jnp.asarray(False), max_iterations=100, gnc_factor=1.4,
            cost_threshold=0.005, interpret=True,
        )
        for i in range(b):
            res_x = gnc_tls_rotation(
                jnp.asarray(src_b[i]), jnp.asarray(dst_b[i]), 0.1,
                max_iterations=100, gnc_factor=1.4, cost_threshold=0.005,
                rot_method="power",
            )
            # Both must recover the true rotation.
            err_p = np.abs(np.asarray(rot_p[i]) - rots[i]).max()
            err_x = np.abs(np.asarray(res_x.rotation) - rots[i]).max()
            assert err_p < 5e-3, f"pallas hyp {i}: {err_p}"
            assert err_x < 5e-3, f"xla hyp {i}: {err_x}"
            # Inlier masks agree on the clean points.
            np.testing.assert_array_equal(
                np.asarray(inl_p[i])[64:], np.asarray(res_x.inliers)[64:]
            )

    def test_warm_start_and_masking(self, rng):
        from psulvsb_tpu.ops.pallas_gnc import gnc_batch
        from tests.test_core import random_rotation

        b, n = 2, 64
        r = random_rotation(rng)
        src = rng.normal(size=(3, n)).astype(np.float32)
        dst = (r @ src).astype(np.float32)
        # Mask out half the columns with garbage — masked lanes must not vote.
        dst[:, n // 2:] = 99.0
        act = np.zeros((b, n), bool)
        act[:, : n // 2] = True
        rot, inl = gnc_batch(
            jnp.asarray(np.stack([src] * b)), jnp.asarray(np.stack([dst] * b)),
            jnp.asarray(act), jnp.full((b,), 0.1, jnp.float32),
            jnp.asarray(r, jnp.float32), jnp.asarray(True),
            max_iterations=100, gnc_factor=1.4, cost_threshold=0.005,
            interpret=True,
        )
        for i in range(b):
            assert np.abs(np.asarray(rot[i]) - r).max() < 5e-3
            assert not bool(jnp.any(inl[i][n // 2:]))


class TestGncPadding:
    @pytest.mark.parametrize("n, width", [(3, 16), (16, 16), (100, 128),
                                          (256, 256), (257, 512), (2048, 2048)])
    def test_padded_width_is_next_power_of_two(self, n, width):
        from psulvsb_tpu.ops.pallas_gnc import padded_width

        assert padded_width(n) == width

    @pytest.mark.parametrize("n, b", [(100, 2), (257, 3)])
    def test_padded_columns_never_vote(self, n, b):
        """N off a power of two: the padded columns are inactive, the
        kernel matches the XLA loop and the planted inliers
        (eval/kernel_checks.check_gnc_kernel, interpret mode)."""
        from psulvsb_tpu.eval.kernel_checks import check_gnc_kernel

        out = check_gnc_kernel(n, b, seed=n, interpret=True)
        assert out["max_angle_vs_truth_deg"] < 0.5
