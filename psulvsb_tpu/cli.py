"""Command-line solve interface — the host-process bridge behind
`matlab/teaser_solve.m`.

Mirrors the MEX argument schema (/root/reference/matlab/teaser_mex.cc:99-244:
src, dst, cbar2, noise_bound, estimate_scaling, rotation_estimation_algorithm,
rotation_gnc_factor, rotation_max_iterations, rotation_cost_threshold,
inlier_selection_algorithm, kcore_heu_threshold -> s, R, t, time_ms) as CLI
flags, so any host language that can write a CSV and spawn a process (MATLAB
`system`, shell, Julia, ...) gets the solver.

Usage:
    python -m psulvsb_tpu.cli --src src.csv --dst dst.csv [--out sol.txt] \
        [--noise-bound 0.03] [--cbar2 1.0] [--estimate-scaling {0,1}] ...

src/dst files: whitespace/comma-separated numeric text, 3 rows x N columns
(MATLAB `writematrix` of a 3-by-N matrix) or N rows x 3 columns.

Output (to --out, default stdout) — fixed schema, one value row per line:
    scale <s>
    rotation <r11> <r12> <r13>
    rotation <r21> <r22> <r23>
    rotation <r31> <r32> <r33>
    translation <t1> <t2> <t3>
    time_ms <milliseconds>
    valid <0|1>
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _read_points(path: str) -> np.ndarray:
    """3xN or Nx3 numeric text -> (3, N) float array."""
    try:
        m = np.loadtxt(path, dtype=np.float64, delimiter=",")
    except ValueError:
        m = np.loadtxt(path, dtype=np.float64)
    m = np.atleast_2d(m)
    if m.shape[0] != 3 and m.shape[1] == 3:
        m = m.T
    if m.shape[0] != 3:
        raise SystemExit(f"{path}: expected a 3-by-N (or N-by-3) matrix, got {m.shape}")
    return m


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="psulvsb_tpu.cli",
        description="Robust point-cloud registration solve (dst = s*R*src + t)",
    )
    p.add_argument("--src", required=True, help="source points file (3xN or Nx3)")
    p.add_argument("--dst", required=True, help="destination points file")
    p.add_argument("--out", default="-", help="output file ('-' = stdout)")
    # teaser_mex.cc parameter schema, same defaults as teaser_solve.m.
    p.add_argument("--cbar2", type=float, default=1.0)
    p.add_argument("--noise-bound", type=float, default=0.03)
    p.add_argument("--estimate-scaling", type=int, default=1, choices=(0, 1))
    p.add_argument(
        "--rotation-estimation-algorithm", type=int, default=0,
        help="0 = GNC-TLS, 1 = FGR",
    )
    p.add_argument("--rotation-gnc-factor", type=float, default=1.4)
    p.add_argument("--rotation-max-iterations", type=int, default=100)
    p.add_argument("--rotation-cost-threshold", type=float, default=0.005)
    p.add_argument(
        "--inlier-selection-algorithm", type=int, default=0,
        help="0 = PMC_EXACT, 1 = PMC_HEU, 2 = KCORE_HEU, 3 = NONE",
    )
    p.add_argument("--kcore-heu-threshold", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--platform", default=None,
        help="force a jax platform (e.g. cpu); default: environment's",
    )
    # Path selector: the MEX binds the full solver (its solve(Eigen, Eigen)
    # overload runs the PSULVSB loop); "decoupled" runs the upstream
    # scale/clique/rotation/translation pipeline instead.
    p.add_argument("--pipeline", default="psulvsb", choices=("psulvsb", "decoupled"))
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.platform:
        import os

        os.environ["JAX_PLATFORMS"] = args.platform
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from psulvsb_tpu.api import RobustRegistrationSolver
    from psulvsb_tpu.solver.config import (
        SolverParams,
        RotationEstimationAlgorithm,
        InlierSelectionMode,
    )

    src = _read_points(args.src)
    dst = _read_points(args.dst)
    if src.shape != dst.shape:
        raise SystemExit(f"src {src.shape} and dst {dst.shape} differ")

    params = SolverParams(
        cbar2=args.cbar2,
        noise_bound=args.noise_bound,
        noise_bound_dataset=args.noise_bound,
        estimate_scaling=bool(args.estimate_scaling),
        rotation_estimation_algorithm=RotationEstimationAlgorithm(
            args.rotation_estimation_algorithm
        ),
        rotation_gnc_factor=args.rotation_gnc_factor,
        rotation_max_iterations=args.rotation_max_iterations,
        rotation_cost_threshold=args.rotation_cost_threshold,
        inlier_selection_mode=InlierSelectionMode(args.inlier_selection_algorithm),
        kcore_heuristic_threshold=args.kcore_heu_threshold,
    )
    solver = RobustRegistrationSolver(params, seed=args.seed)
    t0 = time.perf_counter()
    if args.pipeline == "decoupled":
        sol = solver.solve_decoupled(src, dst)
    else:
        sol = solver.solve(src, dst)
    elapsed_ms = (time.perf_counter() - t0) * 1000.0

    r = np.asarray(sol.rotation, np.float64)
    t = np.asarray(sol.translation, np.float64)
    lines = [f"scale {float(sol.scale):.17g}"]
    for row in range(3):
        lines.append("rotation " + " ".join(f"{v:.17g}" for v in r[row]))
    lines.append("translation " + " ".join(f"{v:.17g}" for v in t))
    lines.append(f"time_ms {elapsed_ms:.3f}")
    lines.append(f"valid {int(bool(sol.valid))}")
    text = "\n".join(lines) + "\n"
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
