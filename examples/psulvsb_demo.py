"""PSULVSB synthetic-protocol demo.

Equivalent of the published experiment driver
(/root/reference/examples/teaser_cpp_ply/PSULVSB.cc) and the binding smoke
example (python/teaserpp_python/teaserpp_example.py): load or synthesize a
cloud, apply a random SE(3) + noise + 90% outliers, register, report errors.

Usage:
    python examples/psulvsb_demo.py [cloud.ply] [--trials N] [--outliers 0.9]
"""

import argparse
import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from psulvsb_tpu.core.metrics import angular_error_deg
from psulvsb_tpu.eval.protocol import run_protocol
from psulvsb_tpu.eval.synthetic import synthetic_cloud
from psulvsb_tpu.io.ply import read_ply
from psulvsb_tpu.solver.config import SolverParams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ply", nargs="*", help="input PLY clouds (synthetic if none)")
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--outliers", type=float, default=0.9)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--out", default="/tmp/psulvsb_demo")
    args = ap.parse_args()

    if args.ply:
        clouds = {p.rsplit("/", 1)[-1].removesuffix(".ply"): read_ply(p) for p in args.ply}
    else:
        clouds = {"synthetic": synthetic_cloud(500, seed=0)}

    params = SolverParams.preset_artificial()
    agg = run_protocol(
        clouds,
        params,
        args.out,
        trials=args.trials,
        noise_bound=args.noise,
        outlier_rate=args.outliers,
    )
    for name, stats in agg.items():
        print(f"== {name} ==")
        for field, (mean, std) in stats.items():
            print(f"  {field}: {mean:.5f} ± {std:.5f}")
    print(f"CSV reports in {args.out}/")


if __name__ == "__main__":
    main()
