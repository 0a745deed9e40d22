"""Multi-device sharding tests on the virtual 8-device CPU mesh — the
equivalent of a fake-backend multi-node test (SURVEY.md §4 implication)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from psulvsb_tpu.core.metrics import angular_error_deg
from psulvsb_tpu.eval.synthetic import synthetic_cloud, make_synthetic_pair
from psulvsb_tpu.parallel.pairs import (
    make_pair_mesh,
    register_batch,
    register_batch_sharded,
)
from psulvsb_tpu.solver.config import SolverParams

TINY = dict(sampled_cap=128, basic_cap=64, hypothesis_batch=2, scale_max_draws=32)


def _make_batch(b, n=48):
    src = jnp.asarray(synthetic_cloud(n, seed=0))
    srcs, dsts, gts = [], [], []
    for i in range(b):
        p = make_synthetic_pair(
            jax.random.PRNGKey(50 + i), src, noise_bound=0.05, outlier_rate=0.5
        )
        srcs.append(p.src)
        dsts.append(p.dst)
        gts.append(p.transform)
    return (
        jnp.stack(srcs),
        jnp.stack(dsts),
        jnp.ones((b, n), jnp.int32),
        jax.random.split(jax.random.PRNGKey(9), b),
        gts,
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestSharded:
    @pytest.mark.slow
    def test_sharded_matches_vmap(self):
        params = SolverParams.preset_artificial(**TINY)
        src_b, dst_b, keep_b, keys, gts = _make_batch(8)
        mesh = make_pair_mesh(jax.devices()[:8])
        sols_sharded, totals = register_batch_sharded(
            mesh, src_b, dst_b, keep_b, keys, params
        )
        sols_local = register_batch(src_b, dst_b, keep_b, keys, params)
        # Same program, same keys -> identical results across shardings.
        np.testing.assert_allclose(
            np.asarray(sols_sharded.rotation),
            np.asarray(sols_local.rotation),
            atol=1e-5,
        )
        assert int(totals["valid_pairs"]) == int(jnp.sum(sols_local.valid))

    def test_sharded_accuracy(self):
        params = SolverParams.preset_artificial(**TINY)
        src_b, dst_b, keep_b, keys, gts = _make_batch(8)
        mesh = make_pair_mesh(jax.devices()[:8])
        sols, totals = register_batch_sharded(mesh, src_b, dst_b, keep_b, keys, params)
        for i, gt in enumerate(gts):
            re = float(angular_error_deg(gt.rotation, sols.rotation[i]))
            assert re < 10.0, f"pair {i}: {re}"

    @pytest.mark.slow
    def test_nonuniform_shards_match_local(self):
        """Adversarial coverage for check_vma=False (parallel/pairs.py):
        2 pairs per device with INVALID pairs distributed non-uniformly
        (device 0 all-padding twice, device 1 once, the rest none). The
        skipped static varying-axes check would flag exactly this kind of
        program if the replicated-vs-varying mix were wrong; instead prove
        dynamically that per-pair results match the unsharded run and the
        psum-reduced summary counts only the valid pairs."""
        params = SolverParams.preset_artificial(**TINY)
        src_b, dst_b, keep_b, keys, _gts = _make_batch(16)
        # keep_mask == -2 is padding: those pairs have zero active points,
        # must come back invalid without poisoning their device's shard.
        keep_b = keep_b.at[0].set(-2).at[1].set(-2).at[2].set(-2)
        mesh = make_pair_mesh(jax.devices()[:8])
        sols_sh, totals = register_batch_sharded(
            mesh, src_b, dst_b, keep_b, keys, params
        )
        sols_lc = register_batch(src_b, dst_b, keep_b, keys, params)

        valid_sh = np.asarray(sols_sh.valid)
        valid_lc = np.asarray(sols_lc.valid)
        assert not valid_sh[:3].any()
        assert valid_sh[3:].all()
        np.testing.assert_array_equal(valid_sh, valid_lc)
        np.testing.assert_allclose(
            np.asarray(sols_sh.rotation), np.asarray(sols_lc.rotation), atol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(sols_sh.final_inlier_count),
            np.asarray(sols_lc.final_inlier_count),
        )
        # Summary reduction (the cross-device psum): totals must equal the per-pair
        # sums, i.e. the replicated output really is the global reduction.
        assert int(totals["valid_pairs"]) == int(valid_lc.sum()) == 13
        assert int(totals["inlier_sum"]) == int(
            np.asarray(sols_lc.final_inlier_count).sum()
        )
