"""Full-cardinality dataset sweep — the reference benchmark's REAL pair
counts, captured as a committed artifact.

The reference's 3DMatch geometric-registration benchmark evaluates 1623
pairs over its 8 test scenes (per-scene counts 506/156/208/226/104/54/292/77
— the published scene split the driver iterates,
teaser_cpp_ply_main.cc:244-795) and 555 KITTI pairs. This tool generates
reference-format scenes at those cardinalities (mixed ~5k corrs/pair for
3DMatch, the reference's real per-pair size; 1500-2500 for KITTI), sweeps
them through the batched harness with scene-granular resume (an aborted
sweep resumes at the completed-scene boundary), and writes the per-scene
CSVs plus a summary JSON into an artifact directory.

Usage:
    python tools/fullscale_sweep.py [--out .fullscale/results] [--data .fullscale/data]
        [--datasets 3dmatch,kitti] [--ddtime 10]
Resume is always on: rerunning after an abort skips completed scenes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

import jax

from psulvsb_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from psulvsb_tpu.eval.batch_harness import run_benchmark_batched, warm_scene
from psulvsb_tpu.eval.make_dataset import write_benchmark
from psulvsb_tpu.eval.realdata import THREEDMATCH_SCENES
from psulvsb_tpu.solver.config import SolverParams

# The published per-scene pair counts of the 3DMatch test split (sum 1623).
THREEDMATCH_PAIRS = {
    "7-scenes-redkitchen": 506,
    "sun3d-home_at-home_at_scan1_2013_jan_1": 156,
    "sun3d-home_md-home_md_scan9_2012_sep_30": 208,
    "sun3d-hotel_uc-scan3": 226,
    "sun3d-hotel_umd-maryland_hotel1": 104,
    "sun3d-hotel_umd-maryland_hotel3": 54,
    "sun3d-mit_76_studyroom-76-1studyroom2": 292,
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": 77,
}
KITTI_PAIRS = 555  # teaser_cpp_ply_main.cc:714 / BASELINE.md

CAPS = dict(sampled_cap=2048, basic_cap=256, hypothesis_batch=4)


def sweep(dataset: str, data_root: str, out_dir: str, ddtime: int) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    if dataset == "3dmatch":
        scenes = list(THREEDMATCH_SCENES)
        n_pairs = THREEDMATCH_PAIRS
        n_corr = (3500, 5000, 6500)  # mean 5000, three pad buckets
        params = SolverParams.preset_3dmatch(**CAPS)
        total_expect = sum(THREEDMATCH_PAIRS.values())
    elif dataset == "kitti":
        scenes = [f"kitti_seq{i:02d}" for i in range(8)]
        base = KITTI_PAIRS // 8
        n_pairs = {s: base + (1 if i < KITTI_PAIRS % 8 else 0)
                   for i, s in enumerate(scenes)}
        n_corr = (1500, 2500)
        params = SolverParams.preset_kitti(**CAPS)
        total_expect = KITTI_PAIRS
    else:
        raise ValueError(dataset)

    root = os.path.join(data_root, dataset)
    # Generation is deterministic in this config; skip only when the
    # recorded generation config matches exactly (a bare existence check
    # would silently sweep stale data after a config edit — review r4).
    cfg = {
        "dataset": dataset, "scenes": scenes, "n_pairs": n_pairs,
        "n_corr": list(n_corr), "seed": 11,
    }
    cfg_path = os.path.join(root, "gen_config.json")
    have = None
    try:
        with open(cfg_path) as f:
            have = json.load(f)
    except (OSError, ValueError):
        pass
    if have != cfg:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
        t0 = time.monotonic()
        write_benchmark(root, scenes, dataset=dataset, n_pairs=n_pairs,
                        n_corr=n_corr, seed=11)
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        print(f"[fullscale] generated {dataset} in "
              f"{time.monotonic() - t0:.0f} s", file=sys.stderr)

    warm_scene(os.path.join(root, scenes[0]), params)
    t0 = time.monotonic()
    summary = run_benchmark_batched(
        root, out_dir, dataset=dataset, scenes=scenes, params=params,
        ddtime=ddtime, resume=True,
    )
    wall = time.monotonic() - t0
    total = sum(s["pairs"] for s in summary.values())
    succ = sum(round(s["recall"] * s["pairs"]) for s in summary.values())
    swept = [s for s in summary.values() if s.get("timing") != "resumed"]
    agg = {
        "dataset": dataset,
        "pairs": total,
        "pairs_expected": total_expect,
        "ddtime": ddtime,
        "recall": round(succ / max(total, 1), 4),
        "per_scene_recall": {k: round(s["recall"], 4)
                             for k, s in summary.items()},
        "sweep_wall_s": round(wall, 1),
        "swept_this_run": sum(s["pairs"] for s in swept),
        "caps": CAPS,
        "n_corr": list(n_corr),
    }
    return agg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=".fullscale/results")
    ap.add_argument("--data", default=".fullscale/data")
    ap.add_argument("--datasets", default="3dmatch,kitti")
    ap.add_argument("--ddtime", type=int, default=10)
    args = ap.parse_args()

    results = {}
    summary_path = os.path.join(args.out, "summary.json")
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            results = json.load(f)
    for ds in args.datasets.split(","):
        agg = sweep(ds, args.data, os.path.join(args.out, ds), args.ddtime)
        results[ds] = agg
        os.makedirs(args.out, exist_ok=True)
        with open(summary_path + ".tmp", "w") as f:
            json.dump(results, f, indent=1)
        os.replace(summary_path + ".tmp", summary_path)
        print(json.dumps(agg))


if __name__ == "__main__":
    main()
