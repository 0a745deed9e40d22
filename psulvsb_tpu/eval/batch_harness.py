"""Batched / sharded real-data dataset sweep — the accelerator harness path.

The reference benchmark driver solves its 1623 3DMatch pairs one at a time
(/root/reference/TEASER-plusplus/examples/teaser_cpp_ply/
teaser_cpp_ply_main.cc:330-422, best-of-ddtime by GT RMSE). The serial
equivalent lives in eval/realdata.py; this module is the scaling axis
SURVEY.md §2.3 names: all (pair, retry) solves of a scene ride ONE device
program — `lax.map` of fused solves on a single chip, or `shard_map` over a
1-D pair mesh with the recall reduction as one psum (parallel/pairs.py).

Semantics preserved vs the serial harness (eval/realdata.py:128-242):
- per pair, ddtime retries; even retries use the (deterministic)
  normal-angle prefilter mask, odd retries run unfiltered (the shared
  eval/realdata.retry_uses_prefilter rule);
- best retry kept by RMSE against the GT placement;
- the reference's success criteria applied per pair.

Divergence (documented): per-pair wall time cannot be observed inside a
batched dispatch, so `time_s` is the batch wall clock amortized per pair
(stats carry `timing = "amortized-batch"`). The timed region covers the
prefilter dispatch, (pair, retry) flattening, the solve batch, and the
result readback — the same work the serial harness counts per retry
(pipeline.solve_with_prefilter) minus per-retry prefilter repetition (the
filter is deterministic, so the batch computes it once per pair). The
reference's 60 s success budget gates the WINNING retry's solve time
(main.cc:424, onceTimeError), so the batched criterion charges each pair
the projected per-retry time — batch wall / solve count, uniform within a
bucket group (stats carry `time_gate = "projected-per-retry"`). Batched
recall thereby applies the reference's full success definition; the
projection only blurs per-pair variation inside one compiled program's
group.
"""

from __future__ import annotations

import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.core.metrics import angular_error_deg_np
from psulvsb_tpu.eval.realdata import (
    PairResult,
    SuccessCriteria,
    read_corr_file,
    read_gt_mat,
    read_pair_labels,
    retry_uses_prefilter,
)
from psulvsb_tpu.eval.reporting import write_csv
from psulvsb_tpu.frontend.histogram_filter import normal_angle_histogram_filter
from psulvsb_tpu.frontend.normals import estimate_normals
from psulvsb_tpu.parallel.pairs import (
    make_pair_mesh,
    register_batch,
    register_batch_sharded,
)
from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.utils.padding import pad_columns, pad_to_bucket


@jax.jit
def _prefilter_batch(src_b: jax.Array, dst_b: jax.Array, valid_b: jax.Array):
    """Batched normal-angle prefilter: (B, 3, C) -> (B, C) keep masks
    (PSULVSB.cc:35-172 semantics; deterministic, so one pass covers every
    prefilter-on retry).

    lax.map, not vmap: the normals kNN materializes per-pair (C, C)-class
    buffers, so a vmapped batch scales HBM with B — a 169-pair group at
    the 6144 bucket OOMed the chip (16.4 G needed of 15.75 G) on the
    full-cardinality 3DMatch sweep. lax.map holds one pair's buffers at a
    time inside the same single dispatch (the register_batch convention,
    parallel/pairs.py)."""

    def one(args):
        src, dst, valid = args
        sn = estimate_normals(src, k=20, active=valid)
        dn = estimate_normals(dst, k=20, active=valid)
        keep, _ = normal_angle_histogram_filter(sn, dn, active=valid)
        return jnp.where(valid, keep, -2).astype(jnp.int32)

    return jax.lax.map(one, (src_b, dst_b, valid_b))


# Prefilter dispatches run at a fixed batch shape so ONE compiled program
# (per pad bucket) serves every scene regardless of its pair count —
# group-sized shapes would recompile per (scene, bucket) group.
PREFILTER_CHUNK = 32


def _prefilter_chunked(src_b, dst_b, valid_b):
    n = src_b.shape[0]
    outs = []
    for lo in range(0, n, PREFILTER_CHUNK):
        sl = slice(lo, lo + PREFILTER_CHUNK)
        s, d, v = src_b[sl], dst_b[sl], valid_b[sl]
        short = PREFILTER_CHUNK - s.shape[0]
        if short > 0:
            s = jnp.concatenate([s, jnp.repeat(s[:1], short, axis=0)])
            d = jnp.concatenate([d, jnp.repeat(d[:1], short, axis=0)])
            v = jnp.concatenate([v, jnp.repeat(v[:1], short, axis=0)])
        outs.append(_prefilter_batch(s, d, v))
    return jnp.concatenate(outs)[:n]


# Solve batches run in fixed-size chunks so ONE compiled program (per pad
# bucket x params) serves every scene and dataset — a shape-per-scene batch
# would recompile per scene and the compile would land inside the timed
# sweep. 64 divides evenly over any power-of-two mesh.
CHUNK = 64
_WARMED: set = set()


def _chunk_pad(arrs, chunk):
    b = arrs[0].shape[0]
    padded = -(-b // chunk) * chunk
    if padded == b:
        return arrs, b
    reps = padded - b
    return [
        jnp.concatenate([a, jnp.repeat(a[:1], reps, axis=0)]) for a in arrs
    ], b


def _solve_batch(src_b, dst_b, keep_b, keys, params, mesh=None, chunk=CHUNK):
    """Dispatch the (B, ...) solve batch in fixed-size chunks (padded with
    repeats of entry 0; padding results dropped via the returned count).
    Sharded over the mesh when given."""
    if mesh is not None and mesh.size > 1:
        chunk = -(-chunk // mesh.size) * mesh.size
    (src_b, dst_b, keep_b, keys), b = _chunk_pad(
        [src_b, dst_b, keep_b, keys], chunk
    )
    outs = []
    for lo in range(0, src_b.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        if mesh is None or mesh.size <= 1:
            outs.append(
                register_batch(src_b[sl], dst_b[sl], keep_b[sl], keys[sl], params)
            )
        else:
            sols, _totals = register_batch_sharded(
                mesh, src_b[sl], dst_b[sl], keep_b[sl], keys[sl], params
            )
            outs.append(sols)
    return jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs), b


def _warm_prefilter(c: int) -> None:
    """Compile + one dispatch of the (PREFILTER_CHUNK, 3, c) prefilter
    program (untimed); the chunked front door makes this the only
    prefilter shape any scene dispatches."""
    wk = ("prefilter", PREFILTER_CHUNK, c)
    if wk in _WARMED:
        return
    z = jnp.zeros((PREFILTER_CHUNK, 3, c), jnp.float32)
    _ = np.asarray(
        _prefilter_batch(z, z, jnp.ones((PREFILTER_CHUNK, c), bool))
    )
    _WARMED.add(wk)


def _warm_chunk(src0, dst0, keep0, key0, params, mesh, chunk=CHUNK):
    """Compile + one dispatch of the chunk-shaped program (untimed; the C++
    reference has no compile step)."""
    if mesh is not None and mesh.size > 1:
        chunk = -(-chunk // mesh.size) * mesh.size
    wk = (src0.shape[-1], params, None if mesh is None else mesh.size, chunk)
    if wk in _WARMED:
        return
    rep = lambda a: jnp.repeat(a[None], chunk, axis=0)
    sols, _ = _solve_batch(
        rep(src0), rep(dst0), rep(keep0),
        jnp.repeat(key0[None], chunk, axis=0), params, mesh, chunk,
    )
    _ = float(sols.scale[0])
    _WARMED.add(wk)


def _flatten(src_b, dst_b, pre_keep, raw_keep, group_keys, ddtime,
             use_prefilter):
    """(pair, retry) flattening: retry t of pair p sits at p * ddtime + t.
    Filtered/raw allocation per retry follows the ONE shared rule
    (eval/realdata.retry_uses_prefilter: even retries filtered, odd raw).
    Per-retry keys derive in one vmapped fold_in dispatch."""
    n_g = src_b.shape[0]
    idx = np.repeat(np.arange(n_g), ddtime)
    retry = np.tile(np.arange(ddtime), n_g)
    use_pre = np.asarray([
        retry_uses_prefilter(int(t), ddtime, use_prefilter) for t in retry
    ])
    keep_flat = jnp.where(
        jnp.asarray(use_pre)[:, None], pre_keep[idx], raw_keep[idx]
    )
    keys = jax.vmap(jax.random.fold_in)(
        group_keys[idx], jnp.asarray(retry, jnp.uint32)
    )
    return src_b[idx], dst_b[idx], keep_flat, keys


def warm_scene(
    scene_dir: str,
    params: SolverParams,
    descriptor: str = "fpfh",
    mesh=None,
) -> None:
    """Compile + one dispatch of the chunk program for EVERY pad bucket a
    scene's pairs occupy (untimed; the C++ reference has no compile step).
    Mixed-cardinality scenes span several buckets — warming only the first
    pair's bucket would land the other buckets' multi-minute chunk
    compiles inside the caller's timed sweep (review r4). Reads the
    scene's own pair files so callers don't re-implement the corr-file
    naming, bucket padding, or keep-mask conventions this module owns."""
    pairs = read_pair_labels(os.path.join(scene_dir, "pairs.txt"))
    suffix = "@corr.txt" if descriptor == "fpfh" else "@corr_fcgf.txt"
    warmed_buckets: set[int] = set()
    for a, b in pairs:
        src, _dst = read_corr_file(
            os.path.join(scene_dir, f"cloud_bin_{a}+cloud_bin_{b}{suffix}")
        )
        bucket = pad_to_bucket(src.shape[1])
        if bucket in warmed_buckets:
            continue
        warmed_buckets.add(bucket)
        src0 = jnp.asarray(pad_columns(np.asarray(src, np.float32), bucket))
        keep0 = jnp.where(
            jnp.arange(bucket) < src.shape[1], 1, -2
        ).astype(jnp.int32)
        _warm_chunk(src0, src0, keep0, jax.random.PRNGKey(0), params, mesh)


def run_scene_batched(
    scene_dir: str,
    label_file: str,
    params: SolverParams,
    criteria: SuccessCriteria,
    out_csv: str,
    descriptor: str = "fpfh",
    ddtime: int = 10,
    unknown_scale: bool = False,
    seed: int = 0,
    use_prefilter: bool = True,
    sharded: bool = False,
    certify: bool = False,
    certify_tim_cap: int = 64,
) -> dict:
    """Evaluate one scene with all (pair, retry) solves batched on-device.

    Pairs are grouped by pad bucket so each group reuses one compiled
    program. Returns the same aggregate stats as eval/realdata.run_scene
    plus `pairs_per_s` (scene pairs / total solve wall-clock) and
    `timing = "amortized-batch"`.

    certify=True runs the DRS optimality certifier (certify/drs.py,
    certification.cc:20-190 equivalent) on each pair's WINNING solve — the
    reference's first-class post-solve step (teaserpp_python.cc:169-207).
    The rotation subproblem is reconstructed exactly the way the solver
    poses it: final correspondence inliers by residual against the winning
    (s, R, t), chain TIMs over those inliers (capped at certify_tim_cap by
    even subsampling — the certifier's DRS iteration is O(N^2) dense), TIM
    noise bound 2x the point bound, TLS theta signs from the TIM residuals.
    polish=True (one f64 Procrustes re-center; README divergence 6: an f32
    winner carries ~1e-7 orientation error that the gap divides by
    mu ~ noise^2). Stats gain `certified_frac` (certified successes /
    successes) and `avg_cert_gap` (mean best_suboptimality over certified
    solves)."""
    pairs = read_pair_labels(label_file)
    suffix = "@corr.txt" if descriptor == "fpfh" else "@corr_fcgf.txt"
    gt_suffix = "@GTmat.txt" if descriptor == "fpfh" else "@GTmat_fcgf.txt"

    mesh = make_pair_mesh() if sharded and len(jax.devices()) > 1 else None

    # Load + bucket all pairs. Per-pair keys (and the unknown-scale test
    # factors) derive in ONE vmapped dispatch — a fold_in per pair/retry
    # would cost a device round-trip each.
    base_key = jax.random.PRNGKey(seed)
    salts = jnp.asarray([a * 100003 + b for a, b in pairs], jnp.int32)
    pair_keys = jax.vmap(lambda s: jax.random.fold_in(base_key, s))(salts)
    # ONE host readback; per-pair rows below must slice numpy, not the
    # device array (a device gather per pair is a dispatch each).
    pair_keys_np = np.asarray(pair_keys)
    if unknown_scale:
        test_scales = np.asarray(
            1.0
            + 4.0
            * jax.vmap(
                lambda k: jax.random.uniform(jax.random.fold_in(k, 7))
            )(pair_keys)
        )
    else:
        test_scales = np.ones((len(pairs),))

    loaded = []  # (tag, src, dst, gt, test_scale, key, bucket)
    for n, (a, b) in enumerate(pairs):
        stem = os.path.join(scene_dir, f"cloud_bin_{a}+cloud_bin_{b}")
        src, dst = read_corr_file(stem + suffix)
        gt = read_gt_mat(stem + gt_suffix)
        test_scale = float(test_scales[n])
        loaded.append(
            (f"{a}+{b}", src, dst * test_scale, gt, test_scale,
             pair_keys_np[n], pad_to_bucket(src.shape[1]))
        )

    results: dict[str, PairResult] = {}
    cert_results: dict[str, dict] = {}
    solve_wall = 0.0
    for bucket in sorted({rec[6] for rec in loaded}):
        group = [rec for rec in loaded if rec[6] == bucket]
        src_b = jnp.asarray(
            np.stack([pad_columns(np.asarray(r[1], np.float32), bucket) for r in group])
        )
        dst_b = jnp.asarray(
            np.stack([pad_columns(np.asarray(r[2], np.float32), bucket) for r in group])
        )
        valid_b = jnp.asarray(
            np.arange(bucket)[None, :]
            < np.asarray([r[1].shape[1] for r in group])[:, None]
        )
        raw_keep = jnp.where(valid_b, 1, -2).astype(jnp.int32)
        n_g = len(group)
        group_keys = jnp.asarray(np.stack([rec[5] for rec in group]))
        # Compile warm-up, untimed (the C++ reference has no compile step):
        # raw-mask inputs are shape-identical to the real flattened batch.
        if use_prefilter:
            _warm_prefilter(bucket)
        _warm_chunk(
            src_b[0], dst_b[0], raw_keep[0], group_keys[0], params, mesh
        )
        # Warm the tiny per-shape flatten/pad programs (gather, where,
        # vmapped fold_in, chunk-pad concat): each is a distinct XLA compile
        # keyed on (n_g, ddtime, bucket), and on the first scene of a new
        # shape they would otherwise land inside the timed region (measured:
        # a 12-pair scene read 0.9 s/pair vs its 0.076 s/pair twin from
        # exactly this).
        wf = ("flatten", n_g, ddtime, bucket, bool(use_prefilter),
              None if mesh is None else mesh.size)
        if wf not in _WARMED:
            f_arrs = _flatten(
                src_b, dst_b, raw_keep, raw_keep, group_keys, ddtime,
                use_prefilter,
            )
            wchunk = CHUNK
            if mesh is not None and mesh.size > 1:
                wchunk = -(-wchunk // mesh.size) * mesh.size
            (padded, *_rest), _b = _chunk_pad(list(f_arrs), wchunk)
            _ = np.asarray(padded[-1, 0])
            _WARMED.add(wf)

        # The timed region covers everything the serial harness counts per
        # retry (eval/pipeline.solve_with_prefilter times normals +
        # prefilter + solve): prefilter dispatch, (pair, retry) flattening,
        # the solve batch, and the result readback.
        t0 = time.monotonic()
        if use_prefilter:
            pre_keep = _prefilter_chunked(src_b, dst_b, valid_b)
        else:
            pre_keep = raw_keep

        src_flat, dst_flat, keep_flat, keys = _flatten(
            src_b, dst_b, pre_keep, raw_keep, group_keys, ddtime,
            use_prefilter,
        )

        sols, n_flat = _solve_batch(src_flat, dst_flat, keep_flat, keys, params, mesh)
        scales = np.asarray(sols.scale)[:n_flat]
        rots = np.asarray(sols.rotation)[:n_flat]
        transs = np.asarray(sols.translation)[:n_flat]
        solve_wall += time.monotonic() - t0

        # Two projections from the batch wall clock:
        # - per_pair: a pair's share of the batch (its ddtime retries) —
        #   the throughput-true figure reported in the Time column;
        # - per_retry: one solve's share — the quantity the reference's
        #   60 s success gate actually measures (main.cc:424 gates
        #   onceTimeError, the WINNING retry's solve time, not the sum).
        #   Charging it per pair applies the reference's full success
        #   definition to batched recall; uniform-within-
        #   group is the projection assumption (solves in a group share one
        #   compiled program and pad bucket).
        amortized = (time.monotonic() - t0) / n_g
        per_retry = (time.monotonic() - t0) / max(n_flat, 1)
        for p, rec in enumerate(group):
            tag, src, _dst_s, gt, test_scale, _key, _bkt = rec
            src_j = np.asarray(src, np.float64)
            gt_pts = gt[:3, :3] @ src_j + gt[:3, 3:4]
            best = None
            best_f = -1
            for t in range(ddtime):
                f = p * ddtime + t
                s, r, tr = float(scales[f]), rots[f].astype(np.float64), transs[f].astype(np.float64)
                est = s * (r @ src_j + tr[:, None])
                rmse = float(
                    np.sqrt(np.mean(np.sum((gt_pts - est / test_scale) ** 2, axis=0)))
                )
                res = PairResult(
                    scale_error=abs(s - test_scale),
                    angle_error_deg=angular_error_deg_np(gt[:3, :3], r),
                    trans_error=float(
                        np.linalg.norm(tr * s / test_scale - gt[:3, 3])
                    ),
                    rmse=rmse,
                    time_s=amortized,
                    success=False,
                )
                # NaN-safe best-of: a NaN RMSE (collapsed solve — e.g. the
                # prefilter discarding nearly every point) compares False
                # against everything, so `res.rmse < best.rmse` would freeze
                # a retry-0 NaN as "best" and mask every later good retry
                # (observed: the unknown-scale protocol's one residual
                # failure was exactly this).
                if best is None or _rmse_key(res) < _rmse_key(best):
                    best = res
                    best_f = f
            # Full reference success definition including the 60 s budget,
            # charged as the projected per-retry solve time (see above).
            ok = (
                best.scale_error <= criteria.max_scale_err
                and best.angle_error_deg <= criteria.max_angle_err_deg
                and best.trans_error <= criteria.max_trans_err
                and per_retry <= criteria.max_time_s
            )
            results[tag] = best._replace(success=ok)
            if certify:
                cert_results[tag] = _certify_winner(
                    src_j, np.asarray(rec[2], np.float64),
                    float(scales[best_f]),
                    rots[best_f].astype(np.float64),
                    transs[best_f].astype(np.float64),
                    params, certify_tim_cap,
                )

    rows = [
        [tag, r.scale_error, r.angle_error_deg, r.trans_error, r.rmse,
         r.time_s, int(r.success)]
        for tag, r in results.items()
    ]
    write_csv(
        out_csv,
        ["pair", "ScaleError", "AngleError", "TransError", "RMSE", "Time", "Success"],
        rows,
    )
    res_list = list(results.values())
    succ = [r for r in res_list if r.success]
    n_s = max(len(succ), 1)
    stats = {
        "pairs": len(res_list),
        "recall": len(succ) / max(len(res_list), 1),
        "avg_scale_error": sum(r.scale_error for r in succ) / n_s,
        "avg_angle_error_deg": sum(r.angle_error_deg for r in succ) / n_s,
        "avg_trans_error": sum(r.trans_error for r in succ) / n_s,
        "avg_rmse": sum(r.rmse for r in succ) / n_s,
        "avg_time_s": sum(r.time_s for r in succ) / n_s,
        "pairs_per_s": len(res_list) / solve_wall if solve_wall > 0 else 0.0,
        "timing": "amortized-batch",
        "time_gate": "projected-per-retry",
        "sharded": mesh is not None,
    }
    if certify:
        # Certified fraction over SUCCESSES: certification asks "is this
        # solve provably the TLS global optimum", which is only meaningful
        # for solves that are solutions at all.
        cert_succ = [cert_results[tag] for tag, r in results.items()
                     if r.success]
        n_cert = sum(1 for c in cert_succ if c["certified"])
        gaps = [c["gap"] for c in cert_succ
                if c["certified"] and math.isfinite(c["gap"])]
        stats["certified_frac"] = n_cert / max(len(cert_succ), 1)
        stats["avg_cert_gap"] = (sum(gaps) / len(gaps)) if gaps else None
    # Sidecar for resume: the exact stats plus the protocol fingerprint
    # (written atomically AFTER the CSV, so a kill mid-scene leaves no meta
    # and the scene re-runs).
    import json

    meta_path = out_csv + ".meta.json"
    with open(meta_path + ".tmp", "w") as f:
        json.dump(
            {
                "fingerprint": _scene_fingerprint(
                    params, ddtime, unknown_scale, descriptor, seed,
                    use_prefilter, len(pairs), criteria, certify,
                ),
                "stats": stats,
            },
            f,
        )
    os.replace(meta_path + ".tmp", meta_path)
    return stats


def _scene_fingerprint(params, ddtime, unknown_scale, descriptor, seed,
                       use_prefilter, n_pairs, criteria,
                       certify: bool = False) -> dict:
    """Everything that determines a scene's results; resumed stats are only
    reused when this matches exactly (a CSV alone cannot prove it was
    produced by the same protocol — e.g. the serial harness writes the
    identical filename pattern with possibly different ddtime/params).
    Includes the success criteria: the same solves scored under another
    dataset's gates (3DMatch 15 deg/0.3 m vs KITTI 5 deg/0.6 m) are a
    different result."""
    return {
        "params": repr(params),
        # The honest clique-stage name: repr(params) alone shows the
        # reference enum (PMC_EXACT), which doesn't say whether the exact
        # native callback or the audited on-device greedy actually ran.
        "clique_algorithm": params.effective_clique_algorithm(),
        "ddtime": ddtime,
        "unknown_scale": unknown_scale,
        "descriptor": descriptor,
        "seed": seed,
        "use_prefilter": use_prefilter,
        "n_pairs": n_pairs,
        "criteria": repr(criteria),
        # Invalidates stale sidecars across gate-rule changes (r4 excluded
        # the gate; r5 reinstated it as projected per-retry time).
        "time_gate": "projected-per-retry",
        # Certification adds stats columns: a non-certified sidecar must
        # not serve a certify=True request.
        "certify": certify,
        # Solver CODE changes are invisible to repr(params); the package
        # version ties resumes to the code that produced them (a stale
        # sidecar from an older solver silently masked a behavior change
        # during r4's pool_cap work).
        "version": _pkg_version(),
    }


def _pkg_version() -> str:
    from psulvsb_tpu import __version__

    return __version__


def _certify_winner(src, dst_s, s_b, r_b, t_b, params, tim_cap) -> dict:
    """DRS-certify one winning solve (certification.cc:20-190 semantics).

    Reconstructs the rotation subproblem the solver posed: correspondence
    inliers by residual against (s, R, t) (threshold 2x the dataset noise
    bound, scaled into the dst frame), chain TIMs over the inlier set
    (v2 back in the src metric via /s — TIM noise bound 2x the point
    bound, registration.cc:986-991's convention), theta = TLS signs from
    the TIM rotation residuals. Returns {"certified": bool, "gap": float}
    ({"certified": False, "gap": inf} when fewer than 4 inliers exist —
    nothing to certify)."""
    est = s_b * (r_b @ src + t_b[:, None])
    resid = np.linalg.norm(dst_s - est, axis=0)
    # dst noise is test_scale-amplified; s_b ~ test_scale for any sane solve.
    thr = 2.0 * params.noise_bound_dataset * max(s_b, 1e-6)
    inl = np.where(resid <= thr)[0]
    if inl.size < 4:
        return {"certified": False, "gap": float("inf")}
    if inl.size > tim_cap + 1:
        inl = inl[np.linspace(0, inl.size - 1, tim_cap + 1).astype(int)]
    v1 = src[:, inl[1:]] - src[:, inl[:-1]]
    v2 = (dst_s[:, inl[1:]] - dst_s[:, inl[:-1]]) / max(s_b, 1e-6)
    # TIM noise bound under the benchmark's noise model: per-axis uniform
    # +-nb (the reference's own — Eigen ::Random * NOISE_BOUND,
    # PSULVSB.cc:190-194) gives point error up to sqrt(3) nb, TIM error up
    # to 2 sqrt(3) nb. The 2x-only bound mislabels razor-edge inlier TIMs
    # as theta=-1 and the certificate then (correctly) refuses: measured
    # gap 0.082 at 2x vs 0.0 at 2 sqrt(3) x on the same winning solve.
    tim_nb = 2.0 * np.sqrt(3.0) * params.noise_bound_dataset
    tim_resid = np.linalg.norm(v2 - r_b @ v1, axis=0)
    theta = np.where(
        tim_resid <= tim_nb * np.sqrt(params.cbar2), 1.0, -1.0
    )
    from psulvsb_tpu.certify.drs import DRSCertifier

    cert = DRSCertifier(noise_bound=tim_nb, cbar2=params.cbar2).certify(
        r_b, v1, v2, theta, polish=True
    )
    return {
        "certified": bool(cert.is_optimal),
        "gap": float(cert.best_suboptimality),
    }


def _rmse_key(r) -> float:
    """Best-of-ddtime ordering key: NaN RMSE sorts WORST (float('nan')
    comparisons are all False, which would otherwise freeze a NaN as the
    running best)."""
    return r.rmse if math.isfinite(r.rmse) else math.inf


def _resume_scene(out_csv: str, fingerprint: dict) -> dict | None:
    """Load the sidecar stats written by a completed run_scene_batched call;
    None unless the stored fingerprint matches the requested protocol."""
    import json

    try:
        with open(out_csv + ".meta.json") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    if meta.get("fingerprint") != fingerprint or not os.path.exists(out_csv):
        return None
    stats = meta.get("stats")
    if isinstance(stats, dict):
        stats = dict(stats)
        stats["timing"] = "resumed"
    return stats


def run_benchmark_batched(
    data_root: str,
    out_dir: str,
    dataset: str = "3dmatch",
    scenes: list[str] | None = None,
    params: SolverParams | None = None,
    descriptor: str = "fpfh",
    ddtime: int = 10,
    unknown_scale: bool = False,
    seed: int = 0,
    use_prefilter: bool = True,
    sharded: bool = False,
    resume: bool = False,
    certify: bool = False,
) -> dict:
    """Dataset sweep through the batched harness (per-scene CSVs + averages
    CSV, same layout as eval/realdata.run_benchmark). resume=True skips
    scenes whose sidecar meta (<csv>.meta.json, written atomically on scene
    completion) matches this run's protocol fingerprint exactly — params,
    ddtime, seed, prefilter, descriptor, pair count — reusing the stored
    stats; anything stale, foreign, or truncated re-runs (scene-granular
    checkpointing; the serial harness checkpoints per pair via JSONL,
    realdata.run_scene)."""
    from psulvsb_tpu.eval.realdata import THREEDMATCH_SCENES

    if params is None:
        if dataset == "kitti":
            params = SolverParams.preset_kitti()
        elif dataset == "whu_tls":
            params = SolverParams.preset_whu_tls()
        else:
            params = SolverParams.preset_3dmatch()
    # estimate_scaling = unknownScale (main.cc:319) — the reference driver
    # ties scale estimation to the protocol, NOT to solver construction, so
    # the rule applies to caller-supplied params too. (Applying it only to
    # the preset branch is exactly how the r4 full-scale sweep ran the
    # known-scale protocol with scale estimation ON: the 14 redkitchen
    # failures were all scale divergences at 95% outliers that the
    # reference's known-scale fixed-s=1 path cannot produce.)
    params = params.replace(estimate_scaling=unknown_scale)
    if dataset == "kitti":
        criteria = SuccessCriteria.kitti()
    elif dataset == "whu_tls":
        criteria = SuccessCriteria.whu_tls()
    else:
        criteria = SuccessCriteria.threedmatch()
    if scenes is None:
        scenes = (
            THREEDMATCH_SCENES
            if dataset in ("3dmatch", "3dlomatch")
            else sorted(os.listdir(data_root))
        )

    os.makedirs(out_dir, exist_ok=True)
    summary = {}
    avg_rows = []
    for scene in scenes:
        scene_dir = os.path.join(data_root, scene)
        out_csv = os.path.join(
            out_dir, f"{scene}_{descriptor}_{int(unknown_scale)}.csv"
        )
        stats = None
        if resume:
            stats = _resume_scene(
                out_csv,
                _scene_fingerprint(
                    params, ddtime, unknown_scale, descriptor, seed,
                    use_prefilter,
                    len(read_pair_labels(os.path.join(scene_dir, "pairs.txt"))),
                    criteria, certify,
                ),
            )
        if stats is None:
            stats = run_scene_batched(
                scene_dir,
                os.path.join(scene_dir, "pairs.txt"),
                params,
                criteria,
                out_csv,
                descriptor=descriptor,
                ddtime=ddtime,
                unknown_scale=unknown_scale,
                seed=seed,
                use_prefilter=use_prefilter,
                sharded=sharded,
                certify=certify,
            )
        summary[scene] = stats
        avg_rows.append([scene] + [stats[k] for k in sorted(stats)])
    if summary:
        write_csv(
            os.path.join(out_dir, f"Average_{dataset}_{descriptor}.csv"),
            ["scene"] + sorted(next(iter(summary.values())).keys()),
            avg_rows,
        )
    return summary
