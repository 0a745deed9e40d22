"""Correspondence-file generator: raw PLY pair -> @corr.txt.

Equivalent of the nested generator driver
(/root/reference/TEASER-plusplus/examples/teaser_cpp_ply/teaser_cpp_ply.cc:
voxel downsample -> ISS keypoints -> FPFH -> NN correspondences -> text file).

Usage:
    python examples/generate_correspondences.py src.ply dst.ply out@corr.txt \
        [--noise-bound 0.05]
"""

import argparse
import sys

sys.path.insert(0, ".")

from psulvsb_tpu.eval.corr_gen import generate_correspondences, write_corr_file
from psulvsb_tpu.io.ply import read_ply


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("src_ply")
    ap.add_argument("dst_ply")
    ap.add_argument("out")
    ap.add_argument("--noise-bound", type=float, default=0.05)
    args = ap.parse_args()

    src = read_ply(args.src_ply)
    dst = read_ply(args.dst_ply)
    s, d = generate_correspondences(src, dst, args.noise_bound)
    write_corr_file(args.out, s, d)
    print(f"{s.shape[1]} correspondences -> {args.out}")


if __name__ == "__main__":
    main()
