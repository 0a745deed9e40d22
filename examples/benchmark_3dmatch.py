"""3DMatch / 3DLoMatch / KITTI real-data benchmark CLI.

Equivalent of the nested benchmark driver
(/root/reference/TEASER-plusplus/examples/teaser_cpp_ply/teaser_cpp_ply_main.cc).
Expects the reference's file layout under --data-root:
    <scene>/cloud_bin_A+cloud_bin_B@corr.txt      (or @corr_fcgf.txt)
    <scene>/cloud_bin_A+cloud_bin_B@GTmat.txt     (or @GTmat_fcgf.txt)
    <scene>/pairs.txt                              (fragment id pairs)

Usage:
    python examples/benchmark_3dmatch.py --data-root DATA --out OUT \
        [--dataset 3dmatch|3dlomatch|kitti|whu_tls] [--descriptor fpfh|fcgf] \
        [--ddtime 10] [--unknown-scale] [--batched] [--sharded]

--batched runs all (pair, retry) solves of a scene as ONE device program
(eval/batch_harness.py — the batched sweep path bench.py uses;
--sharded additionally shard_maps the batch over every visible device).
The default serial path keeps faithful per-pair wall times and
checkpoint/resume.
"""

import argparse
import json
import sys

sys.path.insert(0, ".")

from psulvsb_tpu.eval.realdata import run_benchmark


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", default="3dmatch",
                    choices=["3dmatch", "3dlomatch", "kitti", "whu_tls"])
    ap.add_argument("--descriptor", default="fpfh", choices=["fpfh", "fcgf"])
    ap.add_argument("--ddtime", type=int, default=10)
    ap.add_argument("--unknown-scale", action="store_true")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--batched", action="store_true",
                    help="all solves of a scene in one device program")
    ap.add_argument("--sharded", action="store_true",
                    help="with --batched: shard_map over all devices")
    ap.add_argument("--resume", action="store_true",
                    help="with --batched: skip scenes whose completed sidecar"
                         " meta (<csv>.meta.json) matches this run's protocol"
                         " fingerprint (a bare CSV is not enough)")
    args = ap.parse_args()

    if args.batched or args.sharded:
        from psulvsb_tpu.eval.batch_harness import run_benchmark_batched

        summary = run_benchmark_batched(
            args.data_root,
            args.out,
            dataset=args.dataset,
            scenes=args.scenes,
            descriptor=args.descriptor,
            ddtime=args.ddtime,
            unknown_scale=args.unknown_scale,
            sharded=args.sharded,
            resume=args.resume,
        )
    else:
        summary = run_benchmark(
            args.data_root,
            args.out,
            dataset=args.dataset,
            scenes=args.scenes,
            descriptor=args.descriptor,
            ddtime=args.ddtime,
            unknown_scale=args.unknown_scale,
        )
    print(json.dumps(summary, indent=2))
    recalls = [s["recall"] for s in summary.values()]
    if recalls:
        print(f"mean recall: {sum(recalls) / len(recalls):.4f}")


if __name__ == "__main__":
    main()
