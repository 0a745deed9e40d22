"""Smoke run of the registration system on an NVIDIA GPU.

    python chip_smoke.py               # one card, phases (a)-(f)
    python chip_smoke.py --four-cards  # only the 4-card pair-mesh sweep

Drives the main path once through the entry points users call, at
deployment widths, with every kernel compiled for the card, and checks
each result against ground truth or a plain reference
(psulvsb_tpu/eval/kernel_checks.py states the tolerances):

  (a) the 1889-correspondence, 90%-outlier anchor through
      RobustRegistrationSolver.solve (staged driver) and psulvsb_register
      (fused), bench caps: rotation error < 5 deg, translation error
      < 0.3, valid, and the same seed gives bit-identical results;
  (b) one generated 3DMatch-style scene through the batched harness:
      30 pairs at 3500/5000/6500 correspondences, 60-95% mismatch
      outliers, certify=True, recall by the harness's 3DMatch criteria;
  (c) one unknown-scale pair at C = 5000, and the exact pair-grid
      histogram, beta-window count and init stage at C = 5000 and 16384,
      known and unknown scale, against a float64 sweep;
  (d) one raw-scan pair through voxel, normals, FPFH, matching and the
      solve with the front-end preset (GROR on), against ground truth,
      plus GROR's consistency degree at that pair's C;
  (e) the whole-GNC kernel against the XLA loop at N in {256, 2048} and
      B in {4, 16}, then whole fused solves through either path (same
      keys, poses and inlier counts compared, both timed in turns);
  (f) compiled.memory_analysis() of the fused solve at C = 8192.

Each phase prints one line. Any failed phase makes the exit code 1 and
suppresses the result line. Without a GPU the script exits 2 before
running anything. The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

BENCH_CAPS = dict(sampled_cap=2048, basic_cap=256, hypothesis_batch=4)
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".chip_smoke")


def require(ok, what) -> None:
    """Raise AssertionError(what) unless ok (kept under python -O)."""
    if not ok:
        raise AssertionError(what)


def _pose_errors(sol, rotation, translation) -> tuple[float, float]:
    import numpy as np

    from psulvsb_tpu.core.metrics import angular_error_deg_np

    re = angular_error_deg_np(rotation, sol.rotation)
    te = float(np.linalg.norm(np.asarray(sol.translation) - np.asarray(translation)))
    return re, te


def phase_anchor() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from psulvsb_tpu import RobustRegistrationSolver, SolverParams
    from psulvsb_tpu.eval.synthetic import make_synthetic_pair, synthetic_cloud
    from psulvsb_tpu.solver.fused import psulvsb_register

    params = SolverParams.preset_artificial(**BENCH_CAPS)
    base = jnp.asarray(synthetic_cloud(1889, seed=0))
    pair = make_synthetic_pair(
        jax.random.PRNGKey(1), base, noise_bound=0.05, outlier_rate=0.9
    )
    keep = jnp.ones((1889,), jnp.int32)
    gt_r, gt_t = pair.transform.rotation, pair.transform.translation
    out = {}
    runs = {
        "staged": lambda: RobustRegistrationSolver(params, seed=0).solve(
            pair.src, pair.dst
        ),
        "fused": lambda: psulvsb_register(
            pair.src, pair.dst, keep, jax.random.PRNGKey(0), params
        ),
    }
    for name, run in runs.items():
        first = jax.block_until_ready(run())
        t0 = time.perf_counter()
        second = jax.block_until_ready(run())
        secs = time.perf_counter() - t0
        re, te = _pose_errors(first, gt_r, gt_t)
        require(bool(first.valid), f"{name}: invalid")
        require(re < 5.0 and te < 0.3, f"{name}: RE {re} TE {te}")
        for f in ("scale", "rotation", "translation", "final_inlier_count"):
            require(np.array_equal(
                np.asarray(getattr(first, f)), np.asarray(getattr(second, f))
            ), f"{name}: {f} differs between runs with one seed")
        out[name] = {"re_deg": re, "te": te, "warm_solve_s": secs}
    return out


def phase_harness() -> dict:
    from psulvsb_tpu import SolverParams
    from psulvsb_tpu.eval.batch_harness import run_scene_batched
    from psulvsb_tpu.eval.make_dataset import write_scene
    from psulvsb_tpu.eval.realdata import SuccessCriteria

    scene = os.path.join(WORK_DIR, "scene0")
    write_scene(
        scene, n_pairs=30, n_corr=(3500, 5000, 6500),
        outlier_rates=(0.6, 0.75, 0.85, 0.9, 0.93, 0.95), noise_bound=0.01,
        seed=11, outlier_mode="mismatch",
    )
    t0 = time.perf_counter()
    stats = run_scene_batched(
        scene, os.path.join(scene, "pairs.txt"),
        SolverParams.preset_3dmatch(**BENCH_CAPS),
        SuccessCriteria.threedmatch(), os.path.join(WORK_DIR, "scene0.csv"),
        ddtime=3, certify=True,
    )
    stats["wall_s_with_compile"] = time.perf_counter() - t0
    require(stats["pairs"] == 30, stats)
    require(stats["recall"] >= 0.9, f"recall {stats['recall']}")
    return stats


def phase_scale_and_pair_grid() -> dict:
    import jax
    import jax.numpy as jnp

    from psulvsb_tpu import SolverParams
    from psulvsb_tpu.eval.kernel_checks import check_pair_grid
    from psulvsb_tpu.eval.synthetic import make_synthetic_pair, synthetic_cloud
    from psulvsb_tpu.solver.fused import psulvsb_register

    c, test_scale = 5000, 3.37
    base = jnp.asarray(synthetic_cloud(c, seed=0))
    pair = make_synthetic_pair(
        jax.random.PRNGKey(5), base, noise_bound=0.01, outlier_rate=0.9,
        outlier_mode="mismatch",
    )
    params = SolverParams.preset_3dmatch(estimate_scaling=True, **BENCH_CAPS)
    sol = jax.block_until_ready(psulvsb_register(
        pair.src, pair.dst * test_scale, jnp.ones((c,), jnp.int32),
        jax.random.PRNGKey(0), params,
    ))
    re, te = _pose_errors(sol, pair.transform.rotation, pair.transform.translation)
    scale_err = abs(float(sol.scale) - test_scale)
    require(bool(sol.valid) and re < 5.0 and te < 0.3 and scale_err < 0.1, (
        re, te, scale_err))
    out = {"unknown_scale_5000": {"re_deg": re, "te": te, "scale_err": scale_err}}
    for width in (5000, 16384):
        for scale in (1.0, test_scale):
            out[f"pair_grid_{width}_s{scale}"] = check_pair_grid(
                width, scale, init=True
            )
    return out


def phase_frontend() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from psulvsb_tpu.eval.frontend_protocol import (
        FRONT_BUCKET, frontend_solver_params, make_frontend_pair,
    )
    from psulvsb_tpu.eval.kernel_checks import check_consistency_degree
    from psulvsb_tpu.solver.fused import psulvsb_register

    t0 = time.perf_counter()
    src, dst, gt = make_frontend_pair(11)
    frontend_s = time.perf_counter() - t0
    c = src.shape[1]
    params = frontend_solver_params(**BENCH_CAPS)
    degree = check_consistency_degree(
        src.astype(np.float32), dst.astype(np.float32),
        2.0 * params.gror_resolution,
    )
    s = jnp.asarray(src, jnp.float32)
    d = jnp.asarray(dst, jnp.float32)
    keep = jnp.ones((c,), jnp.int32)
    # Best of three retries by the solver's own inlier count, as the
    # harness scores best-of-ddtime without looking at ground truth.
    sols = [psulvsb_register(s, d, keep, jax.random.PRNGKey(k), params) for k in range(3)]
    best = max(sols, key=lambda x: int(x.final_inlier_count))
    re, te = _pose_errors(best, gt[:3, :3], gt[:3, 3])
    require(bool(best.valid) and re < 5.0 and te < 0.6, (re, te))  # KITTI criteria
    return {"bucket": FRONT_BUCKET, "correspondences": c, "re_deg": re,
            "te": te, "frontend_s_with_compile": frontend_s,
            "consistency_degree": degree}


def phase_gnc_kernel() -> dict:
    from psulvsb_tpu.eval.kernel_checks import check_gnc_kernel, check_gnc_solve

    out = {}
    for n in (256, 2048):
        for b in (4, 16):
            out[f"n{n}_b{b}"] = check_gnc_kernel(n, b, seed=n + b)
    out["warm_n256_b4"] = check_gnc_kernel(256, 4, seed=7, warm=True)
    # Whole fused solves, kernel against the XLA loop: the anchor at the
    # bench caps and at the SolverParams defaults, a 3DMatch pair at C=5000.
    for name, args in (("solve_anchor_bench_caps", (1889, 256, 4)),
                       ("solve_anchor_default_caps", (1889, 2048, 16)),
                       ("solve_3dmatch5000_bench_caps", (5000, 256, 4, "3dmatch"))):
        out[name] = check_gnc_solve(*args)
    return out


def phase_memory() -> dict:
    import jax
    import jax.numpy as jnp

    from psulvsb_tpu import SolverParams
    from psulvsb_tpu.solver.fused import psulvsb_register

    c = 8192
    params = SolverParams.preset_3dmatch(**BENCH_CAPS)
    x = jax.ShapeDtypeStruct((3, c), jnp.float32)
    compiled = (
        jax.jit(psulvsb_register, static_argnames=("params",))
        .lower(x, x, jax.ShapeDtypeStruct((c,), jnp.int32),
               jax.random.PRNGKey(0), params)
        .compile()
    )
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    out = {f: getattr(mem, f, None) for f in fields}
    require(out["temp_size_in_bytes"] is not None, "no memory analysis")
    return out


def phase_four_cards() -> dict:
    """register_batch_sharded over a 4-card pair mesh against the one-card
    register_batch for the same keys and against the known poses."""
    from psulvsb_tpu.eval.kernel_checks import check_sharded_sweep

    return check_sharded_sweep(n_pairs=120, c=5000, n_devices=4)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return "; ".join(line.strip() for line in out.splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card register_batch_sharded phase")
    args = ap.parse_args(argv)

    try:
        import jax

        import psulvsb_tpu  # noqa: F401 — the program must be beside the script
        from psulvsb_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}", file=sys.stderr)
        return 2
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(f"card: {_card_line()}", flush=True)

    if args.four_cards:
        phases = [("four_cards", phase_four_cards)]
    else:
        phases = [
            ("a_anchor", phase_anchor),
            ("b_harness", phase_harness),
            ("c_scale_pair_grid", phase_scale_and_pair_grid),
            ("d_frontend", phase_frontend),
            ("e_gnc_kernel", phase_gnc_kernel),
            ("f_memory", phase_memory),
        ]
    os.makedirs(WORK_DIR, exist_ok=True)
    tempfile.tempdir = WORK_DIR
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
            status = "ok"
        except Exception as e:  # noqa: BLE001 — every phase reports
            traceback.print_exc()
            res = {"error": f"{type(e).__name__}: {e}"[:500]}
            status = "FAIL"
            failed.append(name)
        secs = time.perf_counter() - t0
        print(f"phase {name}: {status} ({secs:.1f} s) {json.dumps(res, default=str)}",
              flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
