"""Repeated-geometry translation aliasing — mechanism regression on REAL
front-end data (docs/FRONTEND_FAILURES.md).

Fixtures are two of the three pairs that failed the r5 end-to-end front-end
protocol (bench.py frontend_benchmark, 120 pairs of real voxel/FPFH/
mutual-NN correspondences at ~1% inlier rate): the exact @corr/@GTmat files
the harness consumed, regenerated deterministically by
eval/frontend_protocol.make_frontend_pair(seed) with the bench seeds
(scene0 pair 44+45 -> seed 1375, scene1 pair 36+37 -> seed 10300).

The measured mechanism: TIMs are translation-invariant, so FPFH matches
landing on a TRANSLATED COPY of repeated scene geometry agree with the true
inliers through the scale and rotation stages and split only at
translation, where the rotation-inlier subset stab can pick the wrong copy
— the solver's returned pose carried LESS global support than ground
truth. These tests pin the two facts that make the rescue
(config.translation_rescue) correct on the real data:

1. the pairs are NOT information-limited: the oracle pose from the true
   inlier matches passes the protocol's KITTI gates easily;
2. under the (near-)true rotation, the global joint translation vote
   recovers the true translation with strictly more support than the
   aliased pose the solver had returned — i.e. the rescue's accept gate
   fires in the right direction on real descriptor data.

The end-to-end evidence (recall 1.0 with gror_init + translation_rescue in
frontend_solver_params) is what the bench's frontend_e2e_* fields
measure.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from psulvsb_tpu.core.metrics import angular_error_deg_np
from psulvsb_tpu.robust.translation import global_translation_vote

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "frontend_aliasing")
NOISE_BOUND = 0.3  # eval/frontend_protocol.NOISE_BOUND
# KITTI success gates (teaser_cpp_ply_main.cc:714) — the front-end
# protocol's criteria.
MAX_RE_DEG, MAX_TE = 5.0, 0.6

# The aliased translations the SOLVER returned on these pairs in the r5
# failure analysis (pre-rescue, best-of-10 by GT RMSE): both carried less
# global support than ground truth.
CASES = [
    ("pair_seed1375", 12),   # scene0 44+45: 12 true inliers of 1250
    ("pair_seed10300", 12),  # scene1 36+37: 12 true inliers of 1275
]


def _load(tag):
    corr = np.loadtxt(os.path.join(HERE, f"{tag}_corr.txt"))
    gt = np.loadtxt(os.path.join(HERE, f"{tag}_gt.txt"))
    return corr[:, :3].T, corr[:, 3:].T, gt  # (3, C), (3, C), (4, 4)


@pytest.mark.parametrize("tag,n_true", CASES)
def test_oracle_pose_passes(tag, n_true):
    """The pairs are not information-limited: weighted Procrustes on the
    ground-truth inlier matches alone passes the protocol gates."""
    src, dst, gt = _load(tag)
    tsrc = gt[:3, :3] @ src + gt[:3, 3:]
    r = np.linalg.norm(tsrc - dst, axis=0)
    m = r <= NOISE_BOUND
    assert int(m.sum()) == n_true
    ms, md = src[:, m].mean(1), dst[:, m].mean(1)
    h = (src[:, m] - ms[:, None]) @ (dst[:, m] - md[:, None]).T
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    t = md - rot @ ms
    assert angular_error_deg_np(gt[:3, :3], rot) <= 1.0
    assert float(np.linalg.norm(gt[:3, 3] - t)) <= 0.1


@pytest.mark.parametrize("tag,n_true", CASES)
def test_global_vote_recovers_true_translation(tag, n_true):
    """Under the true rotation, the joint vote's winning cluster is the
    true translation — and an aliased incumbent (true t displaced by a
    repeated-structure offset) has strictly less support, so the rescue's
    sup_new > sup_cur gate adopts the fix."""
    src, dst, gt = _load(tag)
    c = src.shape[1]
    aliased = gt[:3, 3] + np.array([2.0, 0.0, -2.0])
    t_new, sup_new, sup_cur = global_translation_vote(
        jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32),
        jnp.asarray(gt[:3, :3], jnp.float32), jnp.float32(1.0),
        jnp.ones((c,), bool), NOISE_BOUND, 1.0,
        jnp.asarray(aliased, jnp.float32),
    )
    assert int(sup_new) > int(sup_cur)
    assert int(sup_new) >= n_true
    assert float(np.linalg.norm(np.asarray(t_new) - gt[:3, 3])) <= MAX_TE / 2
