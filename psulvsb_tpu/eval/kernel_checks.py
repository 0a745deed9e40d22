"""Checks of the pair-grid reductions and the GNC kernel against plain
references, at any width. The CPU tests call them at small widths; the
card runs them at deployment widths (chip_smoke.py and the `gpu`-marked
tests). Each check raises AssertionError when a result leaves its stated
tolerance and otherwise returns a dict of what it measured.

Tolerances and the precision they assume:

- Histogram and beta-window counts are compared with a float64 numpy sweep
  of the same float32 inputs. The device computes in float32 from direct
  coordinate differences: a correctly rounded difference of two exact
  inputs, three squares, two sums, a square root and a division, so each
  ratio and length carries a relative error below 1e-6. A pair counts as
  a boundary case when its float64 value lies within REL_TOL = 4e-6
  (relative) of a bin edge or of beta; it may land on either side. Every
  other pair must be counted exactly as float64 counts it, the total
  count must be exact, and the peak bin must be the float64 peak unless
  boundary cases can reorder the two.
- The consistency degree uses the same rule, per row, for |d_s - d_t|
  against tau.
- The GNC kernel is compared with the vmapped XLA loop (rotation/gnc.py,
  rot_method="power") on planted problems with no boundary cases by
  construction: inlier noise at most nb/50 and outliers displaced by at
  least 10 nb. Rotations agree within GNC_ANGLE_TOL_DEG of each other and
  lie within TRUTH_ANGLE_TOL_DEG of the planted rotation; inlier masks are
  equal to each other and to the planted mask.
- Full solves through the kernel are compared with the same solves
  through the XLA loop (check_gnc_solve): both within the 3DMatch criteria
  of the planted pose, and within SOLVE_ANGLE_TOL_DEG, SOLVE_TRANS_TOL and
  SOLVE_COUNT_TOL (relative final inlier count) of each other.
- The sharded pair sweep is compared with the one-device batch for the
  same keys (SHARD_ANGLE_TOL_DEG, SHARD_TRANS_TOL) and both with the known
  poses under the 3DMatch criteria.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.ops.pair_grid import (
    consistency_degree,
    pair_beta_count,
    pair_ratio_histogram,
)

REL_TOL = 4e-6
GNC_ANGLE_TOL_DEG = 0.1
TRUTH_ANGLE_TOL_DEG = 0.5
SHARD_ANGLE_TOL_DEG = 1.0
SHARD_TRANS_TOL = 0.05
SOLVE_ANGLE_TOL_DEG = 1.0
SOLVE_TRANS_TOL = 0.05
SOLVE_COUNT_TOL = 0.02


def require(ok, what) -> None:
    """Raise AssertionError(what) unless ok (kept under python -O)."""
    if not ok:
        raise AssertionError(what)


def _rotation(rng: np.random.Generator) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def pair_problem(
    c: int, scale: float = 1.0, outlier_rate: float = 0.9,
    active_frac: float = 1.0, seed: int = 0, noise: float = 0.01,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A 3DMatch-like correspondence set: C points in a 3 m box, inliers
    mapped by dst = s (R p + t) + noise, outliers uniform in the dst box,
    and a random inactive share. Returns float32 (3, C) src, dst and a
    (C,) bool active mask."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1.5, 1.5, size=(3, c))
    r = _rotation(rng)
    t = rng.uniform(-1.0, 1.0, size=3)
    dst = scale * (r @ src + t[:, None]) + rng.normal(size=(3, c)) * noise
    bad = rng.uniform(size=c) < outlier_rate
    lo, hi = dst.min(axis=1, keepdims=True), dst.max(axis=1, keepdims=True)
    dst = np.where(bad[None, :], rng.uniform(lo, hi, size=(3, c)), dst)
    active = rng.uniform(size=c) < active_frac
    return src.astype(np.float32), dst.astype(np.float32), active


def _f64_rows(src, dst, active, block=512):
    """Yield (v1, v2, valid) float64 row tiles of the i < j pair grid."""
    s = src.astype(np.float64)
    d = dst.astype(np.float64)
    c = s.shape[1]
    col = np.arange(c)
    for r0 in range(0, c, block):
        rows = np.arange(r0, min(r0 + block, c))
        v1 = np.sqrt(np.sum((s[:, None, :] - s[:, rows, None]) ** 2, axis=0))
        v2 = np.sqrt(np.sum((d[:, None, :] - d[:, rows, None]) ** 2, axis=0))
        valid = (rows[:, None] < col[None, :]) & active[rows, None] & active[None, :]
        yield v1, v2, valid


def reference_sweep(src, dst, active, bins_per_unit=20, num_bins=200000,
                    beta=0.02):
    """float64 sweep of the active pairs i < j: the ratio histogram with,
    per bin, the number of boundary pairs that may fall into it, and the
    beta-window count with its number of boundary pairs."""
    counts = np.zeros(num_bins, np.int64)
    amb = np.zeros(num_bins, np.int64)
    beta_count = 0
    beta_amb = 0
    for v1, v2, valid in _f64_rows(src, dst, active):
        x = (v2 / np.where(v1 > 0, v1, 1.0) * bins_per_unit)[valid]
        counts += np.bincount(
            np.clip(np.floor(x), 0, num_bins - 1).astype(np.int64),
            minlength=num_bins,
        )
        edge = np.rint(x)
        near = (np.abs(x - edge) <= REL_TOL * np.maximum(x, 1.0)) & (
            edge >= 1) & (edge <= num_bins - 1)
        e = edge[near].astype(np.int64)
        amb += np.bincount(e - 1, minlength=num_bins)
        amb += np.bincount(e, minlength=num_bins)
        gap = np.abs(v1 - v2)[valid]
        beta_count += int(np.sum(gap <= beta))
        tol = REL_TOL * (v1 + v2)[valid] + 1e-7 * beta
        beta_amb += int(np.sum(np.abs(gap - beta) <= tol))
    return counts, amb, beta_count, beta_amb


def _timed(fn, *args):
    out = jax.block_until_ready(fn(*args))  # compile
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _window(counts, peak):
    return int(counts[max(peak - 1, 0): peak + 2].sum())


def check_pair_grid(
    c: int, scale: float = 1.0, active_frac: float = 1.0, seed: int = 0,
    bins_per_unit: int = 20, num_bins: int = 200000, beta: float = 0.02,
    block: int = 1024, init: bool = False, dense_init_max_c: int = 8192,
) -> dict:
    """ops/pair_grid.pair_ratio_histogram and pair_beta_count against the
    float64 sweep of one generated correspondence set. init=True also runs
    the solver's init stage ("auto" mode, 3DMatch preset whose beta window
    is 2 * 0.01) under both scale modes and checks its |reduced| count;
    dense_init_max_c picks which init path C takes."""
    src, dst, active = pair_problem(c, scale, active_frac=active_frac, seed=seed)
    args = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(active))
    hist, hist_s = _timed(
        lambda s, d, a: pair_ratio_histogram(
            s, d, a, bins_per_unit=bins_per_unit, num_bins=num_bins, block=block
        ),
        *args,
    )
    count, beta_s = _timed(
        lambda s, d, a: pair_beta_count(s, d, beta, a, block=block), *args
    )
    dev = np.asarray(hist).astype(np.int64)
    ref, amb, ref_beta, amb_beta = reference_sweep(
        src, dst, active, bins_per_unit, num_bins, beta
    )
    require(dev.sum() == ref.sum(), (dev.sum(), ref.sum()))
    diff = np.abs(dev - ref)
    bad = np.flatnonzero(diff > amb)
    require(bad.size == 0, f"bins {bad[:5]} differ beyond boundary cases")
    pd, pr = int(np.argmax(dev)), int(np.argmax(ref))
    require(pd == pr or ref[pr] - ref[pd] <= amb[pd] + amb[pr], (pd, pr))
    require(abs(int(count) - ref_beta) <= amb_beta, (int(count), ref_beta, amb_beta))
    out = {
        "c": c, "scale": scale, "peak": pd, "peak_count": int(dev[pd]),
        "ref_peak": pr, "hist_boundary_pairs": int(amb.sum() // 2),
        "bins_off": int(np.count_nonzero(diff)), "beta_count": int(count),
        "beta_ref": ref_beta, "beta_boundary_pairs": amb_beta,
        "hist_device_s": hist_s, "beta_device_s": beta_s,
    }
    if init:
        from psulvsb_tpu.solver.config import SolverParams
        from psulvsb_tpu.solver.psulvsb import _init_stage, resolve_init_mode

        keep = jnp.asarray(active.astype(np.int32))
        for es, want, tol in (
            (True, _window(ref, pr), _window(amb, pr)),
            (False, ref_beta, amb_beta),
        ):
            params = SolverParams.preset_3dmatch(
                estimate_scaling=es, dense_init_max_c=dense_init_max_c
            )
            _, _, red_count, pool = _init_stage(
                args[0], args[1], keep, params, jax.random.PRNGKey(seed)
            )
            cap = params.reduced_cap
            lo, hi = min(want - tol, cap), min(want + tol, cap)
            require(lo <= int(red_count) <= hi, (es, int(red_count), want, tol))
            require(int(pool) > 0, f"empty reduced pool ({es})")
            tag = "unknown_scale" if es else "known_scale"
            out[f"init_{tag}_mode"] = resolve_init_mode(params, c)
            out[f"init_{tag}_red_count"] = int(red_count)
    return out


def check_consistency_degree(src, dst, tau: float, active=None) -> dict:
    """ops/pair_grid.consistency_degree against a float64 numpy sweep."""
    c = src.shape[1]
    if active is None:
        active = np.ones(c, bool)
    dev, secs = _timed(
        consistency_degree, jnp.asarray(src), jnp.asarray(dst), tau,
        jnp.asarray(active),
    )
    dev = np.asarray(dev)
    s = src.astype(np.float64)
    d = dst.astype(np.float64)
    ref = np.zeros(c, np.int64)
    amb = np.zeros(c, np.int64)
    for r0 in range(0, c, 512):
        rows = np.arange(r0, min(r0 + 512, c))
        ds = np.sqrt(np.sum((s[:, None, :] - s[:, rows, None]) ** 2, axis=0))
        dt = np.sqrt(np.sum((d[:, None, :] - d[:, rows, None]) ** 2, axis=0))
        pair = (rows[:, None] != np.arange(c)[None, :]) & active[rows, None] & active[None, :]
        gap = np.abs(ds - dt)
        ref[rows] = np.sum((gap < tau) & pair, axis=1)
        amb[rows] = np.sum(
            (np.abs(gap - tau) <= REL_TOL * (ds + dt) + 1e-7 * tau) & pair, axis=1
        )
    bad = np.flatnonzero(np.abs(dev - ref) > amb)
    require(bad.size == 0, f"rows {bad[:5]} differ beyond boundary cases")
    return {"c": c, "mean_degree": float(ref.mean()),
            "boundary_pairs": int(amb.sum()), "device_s": secs}


def gnc_problem(n: int, b: int, seed: int = 0, nb: float = 0.1,
                outlier_rate: float = 0.3, inactive_rate: float = 0.1,
                shared_rotation: bool = False):
    """b planted GNC problems on (3, n) TIMs with no boundary cases: inliers
    dst = R src + noise (|noise| <= nb/50 per axis), outliers displaced by
    10-30 nb, a random inactive share holding garbage. shared_rotation
    plants one rotation in every problem (the warm-start case)."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, 3, n))
    rots = np.stack([_rotation(rng) for _ in range(b)])
    if shared_rotation:
        rots[:] = rots[0]
    dst = np.einsum("bij,bjn->bin", rots, src)
    dst += rng.uniform(-nb / 50, nb / 50, size=dst.shape)
    u = rng.normal(size=(b, 3, n))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    bad = rng.uniform(size=(b, n)) < outlier_rate
    dst += np.where(bad[:, None, :], u * rng.uniform(10 * nb, 30 * nb, (b, 1, n)), 0.0)
    active = rng.uniform(size=(b, n)) >= inactive_rate
    dst = np.where(active[:, None, :], dst, 99.0)
    return (src.astype(np.float32), dst.astype(np.float32), rots,
            active, active & ~bad)


def _angle_deg(a, b):
    """Rotation angle between (..., 3, 3) rotations in degrees, from
    ||A - B||_F = 2 sqrt(2) sin(theta / 2) — well conditioned near 0,
    where the trace form's arccos is not."""
    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64),
                       axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def check_gnc_kernel(n: int, b: int, seed: int = 0, warm: bool = False,
                     interpret: bool = False, nb: float = 0.1) -> dict:
    """ops/pallas_gnc.gnc_batch against the vmapped XLA GNC loop."""
    from psulvsb_tpu.ops.pallas_gnc import gnc_batch
    from psulvsb_tpu.rotation.gnc import gnc_tls_rotation

    src, dst, rots, active, planted = gnc_problem(
        n, b, seed, nb, shared_rotation=warm
    )
    warm_r = rots[0] if warm else np.eye(3)
    args = (
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(active),
        jnp.full((b,), nb, jnp.float32), jnp.asarray(warm_r, jnp.float32),
        jnp.asarray(warm),
    )
    knobs = dict(max_iterations=100, gnc_factor=1.4, cost_threshold=0.005)

    kernel = jax.jit(lambda *a: gnc_batch(*a, **knobs, interpret=interpret))

    @jax.jit
    def xla(s, d, act, nbs, wr, uw):
        def one(s1, d1, a1, nb1):
            res = gnc_tls_rotation(s1, d1, nb1, active=a1, warm_rotation=wr,
                                   use_warm=uw, rot_method="power", **knobs)
            return res.rotation, res.inliers
        return jax.vmap(one)(s, d, act, nbs)

    (rk, ik), tk = _timed(kernel, *args)
    (rx, ix), tx = _timed(xla, *args)
    rk, ik, rx, ix = map(np.asarray, (rk, ik, rx, ix))
    between = _angle_deg(rk, rx)
    truth = _angle_deg(rk, rots)
    require(np.all(between <= GNC_ANGLE_TOL_DEG), between)
    require(np.all(truth <= TRUTH_ANGLE_TOL_DEG), truth)
    require(np.array_equal(ik, ix), "kernel and XLA inlier masks differ")
    require(np.array_equal(ik, planted), "inliers differ from the planted mask")
    return {"n": n, "b": b, "warm": warm,
            "max_angle_vs_xla_deg": float(between.max()),
            "max_angle_vs_truth_deg": float(truth.max()),
            "kernel_s": tk, "xla_s": tx}


def check_gnc_solve(c: int, basic_cap: int, hypothesis_batch: int,
                    preset: str = "artificial", path: str = "auto",
                    keys: int = 3, repeats: int = 12, seed: int = 0) -> dict:
    """Full fused solves (solver/fused.psulvsb_register) whose GNC batches
    run the whole-GNC kernel (`path` "auto" compiles it where the solve is
    compiled for CUDA; "interpret" runs the Pallas interpreter anywhere)
    against the same solves through the vmapped XLA loop, with the same
    keys. This covers the scale, warm-start and padding wiring around the
    kernel in _local_stage.

    preset "artificial" is the 1889-correspondence-style anchor (noise
    0.05, displaced outliers); "3dmatch" a 3DMatch-style pair (noise 0.01,
    mismatch outliers); both at 90% outliers. For each of `keys` solve
    keys both paths must be valid and within the 3DMatch criteria of the
    planted pose (RE < 5 deg, TE < 0.3), and agree within
    SOLVE_ANGLE_TOL_DEG / SOLVE_TRANS_TOL and SOLVE_COUNT_TOL (relative
    final inlier count): a last-bit difference in one GNC rotation may flip
    an inlier test or a tie between hypotheses downstream. Then the two
    paths are timed on fresh keys in turns A B B A, `repeats` solves each;
    the medians decide whether the kernel earns its place (PERF.md)."""
    from psulvsb_tpu.eval.synthetic import make_synthetic_pair, synthetic_cloud
    from psulvsb_tpu.solver.config import SolverParams
    from psulvsb_tpu.solver.fused import psulvsb_register

    caps = dict(sampled_cap=2048, basic_cap=basic_cap,
                hypothesis_batch=hypothesis_batch)
    if preset == "artificial":
        params = SolverParams.preset_artificial(**caps)
        gen = dict(noise_bound=0.05)
    else:
        params = SolverParams.preset_3dmatch(**caps)
        gen = dict(noise_bound=0.01, outlier_mode="mismatch")
    base = jnp.asarray(synthetic_cloud(c, seed=seed))
    pair = make_synthetic_pair(
        jax.random.PRNGKey(seed + 1), base, outlier_rate=0.9, **gen
    )
    keep = jnp.ones((c,), jnp.int32)
    gt_r = np.asarray(pair.transform.rotation)
    gt_t = np.asarray(pair.transform.translation)

    def solve(gnc_path, k):
        return jax.block_until_ready(psulvsb_register(
            pair.src, pair.dst, keep, jax.random.PRNGKey(k), params,
            _gnc_path=gnc_path,
        ))

    out = {"c": c, "basic_cap": basic_cap, "hypothesis_batch": hypothesis_batch,
           "preset": preset, "path": path}
    t0 = time.perf_counter()
    solve(path, 0)
    out["kernel_compile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    solve("xla", 0)
    out["xla_compile_s"] = time.perf_counter() - t0

    stats = dict.fromkeys(("max_re_deg", "max_angle_kernel_vs_xla_deg",
                           "max_trans_kernel_vs_xla", "max_count_rel_diff"), 0.0)
    identical = 0
    for k in range(keys):
        a, b = solve(path, k), solve("xla", k)
        for name, sol in (("kernel", a), ("xla", b)):
            re = float(_angle_deg(gt_r, np.asarray(sol.rotation)))
            te = float(np.linalg.norm(np.asarray(sol.translation) - gt_t))
            require(bool(sol.valid) and re < 5.0 and te < 0.3,
                    f"{name} key {k}: valid {bool(sol.valid)} RE {re} TE {te}")
            stats["max_re_deg"] = max(stats["max_re_deg"], re)
        angle = float(_angle_deg(np.asarray(a.rotation), np.asarray(b.rotation)))
        dt = float(np.linalg.norm(np.asarray(a.translation) - np.asarray(b.translation)))
        na, nb = int(a.final_inlier_count), int(b.final_inlier_count)
        rel = abs(na - nb) / max(na, nb, 1)
        require(angle <= SOLVE_ANGLE_TOL_DEG and dt <= SOLVE_TRANS_TOL
                and rel <= SOLVE_COUNT_TOL,
                f"key {k}: angle {angle} trans {dt} counts {na} vs {nb}")
        for f, v in (("max_angle_kernel_vs_xla_deg", angle),
                     ("max_trans_kernel_vs_xla", dt), ("max_count_rel_diff", rel)):
            stats[f] = max(stats[f], v)
        identical += int(
            np.array_equal(np.asarray(a.rotation), np.asarray(b.rotation))
            and na == nb
        )
    out.update(stats, identical_keys=identical)

    times = {path: [], "xla": []}
    for r in range(repeats):
        order = (path, "xla") if r % 2 == 0 else ("xla", path)
        for p in order:
            t0 = time.perf_counter()
            solve(p, 100 + r)
            times[p].append(time.perf_counter() - t0)
    out["kernel_median_s"] = float(np.median(times[path]))
    out["xla_median_s"] = float(np.median(times["xla"]))
    out["kernel_min_s"] = float(np.min(times[path]))
    out["xla_min_s"] = float(np.min(times["xla"]))
    return out


def check_sharded_sweep(n_pairs: int, c: int, n_devices: int, seed: int = 0,
                        outlier_rate: float = 0.9) -> dict:
    """parallel/pairs.register_batch_sharded over an n_devices pair mesh
    against the one-device register_batch for the same keys, and both
    against the known poses: every pair valid, rotation error < 5 deg,
    translation error < 0.3 (the 3DMatch criteria), and the two runs
    within SHARD_ANGLE_TOL_DEG / SHARD_TRANS_TOL of each other (the mesh
    program is a different compilation of the same solve, so last-bit
    differences may flip a tie between hypotheses)."""
    from psulvsb_tpu.eval.synthetic import make_synthetic_pair, synthetic_cloud
    from psulvsb_tpu.parallel.pairs import (
        make_pair_mesh, register_batch, register_batch_sharded,
    )
    from psulvsb_tpu.solver.config import SolverParams

    base = jnp.asarray(synthetic_cloud(c, seed=seed))
    gen_keys = jax.random.split(jax.random.PRNGKey(seed + 1), n_pairs)
    pairs = jax.vmap(
        lambda k: make_synthetic_pair(
            k, base, noise_bound=0.01, outlier_rate=outlier_rate,
            outlier_mode="mismatch",
        )
    )(gen_keys)
    keep = jnp.ones((n_pairs, c), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(seed + 2), n_pairs)
    params = SolverParams.preset_3dmatch(
        estimate_scaling=False, sampled_cap=2048, basic_cap=256,
        hypothesis_batch=4,
    )
    mesh = make_pair_mesh(jax.devices()[:n_devices])
    t0 = time.perf_counter()
    sharded, totals = register_batch_sharded(
        mesh, pairs.src, pairs.dst, keep, keys, params
    )
    sharded = jax.block_until_ready(sharded)
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = jax.block_until_ready(
        register_batch(pairs.src, pairs.dst, keep, keys, params)
    )
    single_s = time.perf_counter() - t0
    gt_r = np.asarray(pairs.transform.rotation)
    gt_t = np.asarray(pairs.transform.translation)
    out = {"pairs": n_pairs, "c": c, "devices": n_devices,
           "sharded_s_with_compile": sharded_s, "single_s_with_compile": single_s}
    for name, sol in (("sharded", sharded), ("single", single)):
        re = _angle_deg(gt_r, np.asarray(sol.rotation))
        te = np.linalg.norm(np.asarray(sol.translation) - gt_t, axis=1)
        valid = np.asarray(sol.valid)
        require(valid.all(), f"{name}: invalid pairs {np.flatnonzero(~valid)}")
        require((re < 5.0).all() and (te < 0.3).all(), (
            f"{name}: max RE {re.max()} max TE {te.max()}"))
        out[f"{name}_max_re_deg"] = float(re.max())
        out[f"{name}_max_te"] = float(te.max())
    between = _angle_deg(np.asarray(sharded.rotation), np.asarray(single.rotation))
    dt = np.linalg.norm(
        np.asarray(sharded.translation) - np.asarray(single.translation), axis=1
    )
    require((between <= SHARD_ANGLE_TOL_DEG).all(), between.max())
    require((dt <= SHARD_TRANS_TOL).all(), dt.max())
    require(int(totals["valid_pairs"]) == n_pairs, int(totals["valid_pairs"]))
    same = np.all(
        np.asarray(sharded.rotation) == np.asarray(single.rotation), axis=(1, 2)
    )
    out.update({"bit_identical_pairs": int(same.sum()),
                "max_angle_sharded_vs_single_deg": float(between.max()),
                "max_trans_sharded_vs_single": float(dt.max())})
    return out
