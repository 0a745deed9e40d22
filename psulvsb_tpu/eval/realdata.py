"""Real-data benchmark harness: 3DMatch / 3DLoMatch / KITTI.

Equivalent of the nested benchmark driver
(/root/reference/TEASER-plusplus/examples/teaser_cpp_ply/
teaser_cpp_ply_main.cc:244-795):

- per scene: a pair-label list; per pair: a correspondence text file
  ("sx sy sz tx ty tz" per line, `cloud_bin_A+cloud_bin_B@corr.txt` for
  fpfh / `@corr_fcgf.txt` for fcgf) and a 4x4 ground-truth matrix
  (`@GTmat.txt` / `@GTmat_fcgf.txt`),
- optional random unknown-scale injection (tgt *= 1 + 4*U(0,1)),
- best-of-`ddtime` repeats kept by RMSE,
- success criteria: 3DMatch/3DLoMatch scale err <= 0.1, RE <= 15 deg,
  TE <= 0.3 m, time <= 60 s (line 424); KITTI RE <= 5 deg, TE <= 0.6 m
  (line 714),
- per-scene CSVs + average CSV with registration recall.

This module is the SERIAL harness (one solve per device dispatch, faithful
per-pair wall times, checkpoint/resume). The batched scaling path —
all (pair, retry) solves of a scene in one device program, optionally
shard_map'd over a pair mesh — is eval/batch_harness.py, which bench.py
uses for the reference-scale sweeps.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import math
import numpy as np

from psulvsb_tpu.core.metrics import angular_error_deg_np
from psulvsb_tpu.eval.pipeline import pad_bucket, solve_with_prefilter
from psulvsb_tpu.eval.reporting import write_csv, mean_std
from psulvsb_tpu.solver.config import SolverParams

THREEDMATCH_SCENES = [
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
]


class SuccessCriteria(NamedTuple):
    max_scale_err: float
    max_angle_err_deg: float
    max_trans_err: float
    max_time_s: float

    @staticmethod
    def threedmatch() -> "SuccessCriteria":
        return SuccessCriteria(0.1, 15.0, 0.3, 60.0)  # main.cc:424

    @staticmethod
    def kitti() -> "SuccessCriteria":
        return SuccessCriteria(0.1, 5.0, 0.6, 60.0)  # main.cc:714

    @staticmethod
    def whu_tls() -> "SuccessCriteria":
        """No reference criteria exist for the WHU-TLS regime (the reference
        ships only the commented noise-bound preset, registration.cc:35);
        derived from KITTI's ratios scaled to noise bound 0.15: trans
        0.6 * 0.15/0.1 = 0.9 m at the same 5 deg angle gate."""
        return SuccessCriteria(0.1, 5.0, 0.9, 60.0)



def _rmse_key(r) -> float:
    """Best-of-retry ordering key: NaN RMSE sorts WORST. float('nan')
    comparisons are all False, so `r.rmse < best.rmse` would freeze a
    retry-0 NaN (collapsed solve, e.g. prefilter discarding nearly every
    point) as the running best and mask every later good retry."""
    return r.rmse if math.isfinite(r.rmse) else math.inf

def read_corr_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """'sx sy sz tx ty tz' per line -> ((3, C) src, (3, C) dst)."""
    data = np.loadtxt(path, dtype=np.float64)
    data = np.atleast_2d(data)
    return data[:, 0:3].T.copy(), data[:, 3:6].T.copy()


def read_gt_mat(path: str) -> np.ndarray:
    m = np.loadtxt(path, dtype=np.float64)
    assert m.shape == (4, 4), f"{path}: expected 4x4 GT matrix"
    return m


def read_pair_labels(path: str) -> list[tuple[int, int]]:
    """Pair list file: two integers per line (the fragment ids)."""
    pairs = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) >= 2:
                try:
                    pairs.append((int(tok[0]), int(tok[1])))
                except ValueError:
                    continue
    return pairs


def read_gt_log(path: str) -> dict[tuple[int, int], np.ndarray]:
    """Standard 3DMatch gt.log: blocks of 'id0 id1 total' followed by a 4x4
    transform (the scene pair lists the reference drivers consume,
    teaser_cpp_ply_main.cc:246-263). Returns {(id0, id1): 4x4}."""
    out: dict[tuple[int, int], np.ndarray] = {}
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    i = 0
    while i + 4 <= len(lines):
        hdr = lines[i]
        if len(hdr) < 2:
            i += 1
            continue
        a, b = int(hdr[0]), int(hdr[1])
        mat = np.array([[float(x) for x in lines[i + r][:4]] for r in range(1, 5)])
        out[(a, b)] = mat
        i += 5
    return out


# Programs warmed (compiled + one dispatch) per (pad bucket, params) so a
# pair's recorded time_s never includes jit compilation — the C++ reference
# has no compile step, and its 60 s success budget (main.cc:424) would
# otherwise be eaten by a per-bucket artifact on the first pair.
_WARMED: set = set()


def retry_uses_prefilter(t: int, ddtime: int, use_prefilter: bool) -> bool:
    """Which of the best-of-ddtime retries consult the normal-angle
    prefilter mask. ONE rule shared by the serial and batched harnesses
    (two drifting copies would silently break their parity tests).

    The reference driver filters EVERY retry (main.cc:337) and relies on
    self-update re-admission (keep == 0 -> 1, registration.cc:1399-1488) to
    recover mis-filtered inliers. That recovery cannot bootstrap when the
    filter's kept set contains no inliers at all — observed on 95%-outlier
    mismatch pairs, where the histogram peak locks onto the sin(theta)
    background of random normal angles and the kept bins hold 0 of 250 true
    inliers (the FULLSCALE_r04 redkitchen failures, docs/FULLSCALE.md).
    Retries are best-of by RMSE and a raw solve runs the SAME compiled
    program as a filtered one (the mask is an input, not a shape), so
    alternating filtered/raw retries strictly dominates the all-filtered
    rule for recall while keeping the filter's benefit on pairs it helps.
    Documented divergence from the reference (README): even retries
    filtered, odd retries raw; ddtime == 1 keeps the reference's single
    filtered solve."""
    if not use_prefilter:
        return False
    return t % 2 == 0


class PairResult(NamedTuple):
    scale_error: float
    angle_error_deg: float
    trans_error: float
    rmse: float
    time_s: float
    success: bool


def evaluate_pair(
    src: np.ndarray,
    dst: np.ndarray,
    gt: np.ndarray,
    params: SolverParams,
    criteria: SuccessCriteria,
    key: jax.Array,
    ddtime: int = 10,
    test_scale: float = 1.0,
    use_prefilter: bool = True,
    decoupled_fallback: bool = False,
) -> PairResult:
    """Best-of-ddtime evaluation of one pair (main.cc:330-422): repeat the
    full pipeline, keep the lowest-RMSE run, apply the success criteria.

    The pre-filter is deterministic, so when it mis-discards inliers every
    filtered retry fails the same way (true of the reference too); odd
    retries run without it as a fallback when use_prefilter is on
    (retry_uses_prefilter).

    decoupled_fallback adds ONE extra retry through the classic decoupled
    path (solver/classic.py: scale -> max-clique -> rotation -> translation)
    kept under the same lowest-RMSE rule. The clique stage prunes before
    rotation, which carries the >= 97%-outlier low-overlap pairs where the
    PSULVSB loop (which, like the reference at known scale, feeds all basic
    TIMs to GNC — registration.cc:986-991) plateaus. Off by default: the
    reference's harness has no such retry."""
    src_j = jnp.asarray(src, jnp.float32)
    dst_j = jnp.asarray(dst * test_scale, jnp.float32)
    # Scoring stays in numpy: a jnp op per (pair, retry) result is a device
    # dispatch each.
    src_np = np.asarray(src, np.float64)
    gt_r = np.asarray(gt[:3, :3], np.float64)
    gt_t = np.asarray(gt[:3, 3], np.float64)
    gt_pts = gt_r @ src_np + gt_t[:, None]

    warm_key = (pad_bucket(src_j.shape[1]), params, use_prefilter,
                decoupled_fallback)
    if warm_key not in _WARMED:
        # Untimed warm-up dispatch: compiles the bucket's programs (prefilter
        # + solver share shapes across retries, and the prefilter-off solver
        # program is the same compiled solve with a different keep_mask
        # input, so one warm run covers every retry variant).
        solve_with_prefilter(
            src_j, dst_j, params, jax.random.fold_in(key, 0x7FFFFFFF),
            use_prefilter=use_prefilter,
        )
        if decoupled_fallback:
            from psulvsb_tpu.solver.classic import solve_decoupled

            solve_decoupled(
                src_j, dst_j, params, jax.random.fold_in(key, 0x7FFFFFFE)
            )
        _WARMED.add(warm_key)

    best: PairResult | None = None
    for t in range(ddtime):
        pre = retry_uses_prefilter(t, ddtime, use_prefilter)
        res = solve_with_prefilter(
            src_j, dst_j, params, jax.random.fold_in(key, t), use_prefilter=pre
        )
        sol = res.solution
        # ONE batched readback per retry, then pure-numpy scoring.
        s_np, r_np, t_np = jax.device_get(
            (sol.scale, sol.rotation, sol.translation)
        )
        s_f = float(s_np)
        r64 = np.asarray(r_np, np.float64)
        t64 = np.asarray(t_np, np.float64)
        est_pts = s_f * (r64 @ src_np + t64[:, None])
        # RMSE vs GT placement over all correspondences, scale-normalized
        # (the driver compares in the unscaled frame).
        rmse = float(
            np.sqrt(np.mean(np.sum((gt_pts - est_pts / test_scale) ** 2, axis=0)))
        )
        r = PairResult(
            scale_error=abs(s_f - test_scale),
            angle_error_deg=angular_error_deg_np(gt_r, r64),
            trans_error=float(
                np.linalg.norm(t64 * s_f / test_scale - gt_t)
            ),
            rmse=rmse,
            time_s=res.elapsed_s,
            success=False,
        )
        if best is None or _rmse_key(r) < _rmse_key(best):
            best = r
    # Fallback only when the kept PSULVSB result is clearly failed (RMSE
    # far beyond the noise bound) — the harness's best-of rule already
    # consults GT RMSE, so this gate adds no new information channel, and
    # easy pairs keep their fast-path timing.
    if decoupled_fallback and not (
        best.rmse <= 5.0 * params.noise_bound_dataset
    ):  # NaN RMSE must also trigger the fallback
        from psulvsb_tpu.solver.classic import solve_decoupled

        t0 = time.monotonic()
        dsol, _ = solve_decoupled(
            src_j, dst_j, params, jax.random.fold_in(key, 0x5EED)
        )
        elapsed = time.monotonic() - t0
        # Upstream convention: dst = s * R * src + t (classic.py docstring).
        ds_np, dr_np, dt_np = jax.device_get(
            (dsol.scale, dsol.rotation, dsol.translation)
        )
        ds_f = float(ds_np)
        dr64 = np.asarray(dr_np, np.float64)
        dt64 = np.asarray(dt_np, np.float64)
        est_pts = ds_f * (dr64 @ src_np) + dt64[:, None]
        rmse = float(
            np.sqrt(np.mean(np.sum((gt_pts - est_pts / test_scale) ** 2, axis=0)))
        )
        r = PairResult(
            scale_error=abs(ds_f - test_scale),
            angle_error_deg=angular_error_deg_np(gt_r, dr64),
            trans_error=float(
                np.linalg.norm(dt64 / test_scale - gt_t)
            ),
            rmse=rmse,
            time_s=elapsed,
            success=False,
        )
        if _rmse_key(r) < _rmse_key(best):
            best = r
    ok = (
        best.scale_error <= criteria.max_scale_err
        and best.angle_error_deg <= criteria.max_angle_err_deg
        and best.trans_error <= criteria.max_trans_err
        and best.time_s <= criteria.max_time_s
    )
    return best._replace(success=ok)


def run_scene(
    scene_dir: str,
    label_file: str,
    params: SolverParams,
    criteria: SuccessCriteria,
    out_csv: str,
    descriptor: str = "fpfh",
    ddtime: int = 10,
    unknown_scale: bool = False,
    seed: int = 0,
    resume: bool = True,
    decoupled_fallback: bool = False,
) -> dict:
    """Evaluate one scene directory; returns aggregate stats incl. recall.

    Checkpoint/resume (the reference has none — SURVEY.md §5): per-pair
    results append to `<out_csv>.progress.jsonl`; on restart, completed
    pairs are skipped, so a 1623-pair sweep survives interruption.
    """
    import json

    pairs = read_pair_labels(label_file)
    suffix = "@corr.txt" if descriptor == "fpfh" else "@corr_fcgf.txt"
    gt_suffix = "@GTmat.txt" if descriptor == "fpfh" else "@GTmat_fcgf.txt"

    progress_path = out_csv + ".progress.jsonl"
    done: dict[str, PairResult] = {}
    if resume and os.path.exists(progress_path):
        with open(progress_path) as f:
            for line in f:
                rec = json.loads(line)
                done[rec["pair"]] = PairResult(**{k: rec[k] for k in PairResult._fields})

    rows = []
    results: list[PairResult] = []
    for a, b in pairs:
        tag = f"{a}+{b}"
        if tag in done:
            r = done[tag]
        else:
            stem = os.path.join(scene_dir, f"cloud_bin_{a}+cloud_bin_{b}")
            src, dst = read_corr_file(stem + suffix)
            gt = read_gt_mat(stem + gt_suffix)
            key = jax.random.fold_in(jax.random.PRNGKey(seed), a * 100003 + b)
            test_scale = 1.0
            if unknown_scale:
                test_scale = 1.0 + 4.0 * float(
                    jax.random.uniform(jax.random.fold_in(key, 7))
                )
            r = evaluate_pair(
                src, dst, gt, params, criteria, key, ddtime, test_scale,
                decoupled_fallback=decoupled_fallback,
            )
            os.makedirs(os.path.dirname(progress_path) or ".", exist_ok=True)
            with open(progress_path, "a") as f:
                f.write(json.dumps({"pair": tag, **r._asdict()}) + "\n")
        results.append(r)
        rows.append([tag, r.scale_error, r.angle_error_deg, r.trans_error,
                     r.rmse, r.time_s, int(r.success)])

    write_csv(
        out_csv,
        ["pair", "ScaleError", "AngleError", "TransError", "RMSE", "Time", "Success"],
        rows,
    )
    succ = [r for r in results if r.success]
    n_s = max(len(succ), 1)
    return {
        "pairs": len(results),
        "recall": len(succ) / max(len(results), 1),
        "avg_scale_error": sum(r.scale_error for r in succ) / n_s,
        "avg_angle_error_deg": sum(r.angle_error_deg for r in succ) / n_s,
        "avg_trans_error": sum(r.trans_error for r in succ) / n_s,
        "avg_rmse": sum(r.rmse for r in succ) / n_s,
        "avg_time_s": sum(r.time_s for r in succ) / n_s,
    }


def run_benchmark(
    data_root: str,
    out_dir: str,
    dataset: str = "3dmatch",
    scenes: list[str] | None = None,
    params: SolverParams | None = None,
    descriptor: str = "fpfh",
    ddtime: int = 10,
    unknown_scale: bool = False,
    seed: int = 0,
    decoupled_fallback: bool = False,
) -> dict:
    """Dataset sweep: per-scene CSVs + averages CSV. Layout mirrors the
    reference: <data_root>/<scene>/ holds the corr/GT files and a
    `pairs.txt` label list."""
    if params is None:
        if dataset == "kitti":
            params = SolverParams.preset_kitti()
        elif dataset == "whu_tls":
            params = SolverParams.preset_whu_tls()
        else:
            params = SolverParams.preset_3dmatch()
    # The reference driver ties scale estimation to the unknown-scale
    # protocol (params.estimate_scaling = unknownScale, main.cc:319):
    # the standard runs solve at known scale via the beta-window reduced
    # set (registration.cc:753-767). Applied unconditionally — the rule is
    # the protocol's, not the preset's, so caller-supplied params (cap
    # overrides) must not silently re-enable scale estimation.
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
        stats = run_scene(
            scene_dir,
            os.path.join(scene_dir, "pairs.txt"),
            params,
            criteria,
            os.path.join(out_dir, f"{scene}_{descriptor}_{int(unknown_scale)}.csv"),
            descriptor=descriptor,
            ddtime=ddtime,
            unknown_scale=unknown_scale,
            seed=seed,
            decoupled_fallback=decoupled_fallback,
        )
        summary[scene] = stats
        avg_rows.append([scene] + [stats[k] for k in sorted(stats)])
    write_csv(
        os.path.join(out_dir, f"Average_{dataset}_{descriptor}.csv"),
        ["scene"] + sorted(next(iter(summary.values())).keys()) if summary else ["scene"],
        avg_rows,
    )
    return summary
