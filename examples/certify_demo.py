"""Rotation certification demo.

The DRS certifier (the reference's teaser::DRSCertifier, exposed in its
pybind11 module) verifies global optimality of a rotation estimate for the
QUASAR SDP. This demo solves a registration, then certifies the rotation on
the inlier TIM set.

Usage: python examples/certify_demo.py [--noise 0.002] [--n 12]
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

from psulvsb_tpu.certify import DRSCertifier
from psulvsb_tpu.core.linalg import svd_rot
from psulvsb_tpu.core.se3 import random_se3
from psulvsb_tpu.eval.synthetic import synthetic_cloud


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--noise", type=float, default=0.002)
    ap.add_argument("--n", type=int, default=12)
    args = ap.parse_args()

    src = np.asarray(synthetic_cloud(args.n, seed=0))
    gt = random_se3(jax.random.PRNGKey(3), max_translation=0.0)
    rng = np.random.default_rng(0)
    dst = np.asarray(gt.rotation) @ src + rng.normal(size=src.shape) * args.noise

    r_est = np.asarray(svd_rot(jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32)))
    cert = DRSCertifier(noise_bound=0.01, cbar2=1.0)

    res = cert.certify(r_est, src.astype(np.float32), dst.astype(np.float32),
                       np.ones(args.n, np.float32), polish=True)
    print(f"estimate optimal: {bool(res.is_optimal)} "
          f"(suboptimality gap {float(res.best_suboptimality):.2e})")

    # A deliberately wrong rotation must fail certification.
    res_bad = cert.certify(np.eye(3, dtype=np.float32), src.astype(np.float32),
                           dst.astype(np.float32), np.ones(args.n, np.float32))
    print(f"identity-rotation certified: {bool(res_bad.is_optimal)} (expected False)")


if __name__ == "__main__":
    main()
