"""Anchor-generation CLI (counterpart of cli/genanchors.py, argparse
parity with the reference's genanchors.py): k-means under 1−IoU over the
train labels, writes anchors{k}.txt; --num_clusters 0 sweeps k=1..10.

Usage, from the repository root:
  python -m fastdet_torch.cli.genanchors --traintxt train.txt \\
      [--output_dir ./] [--num_clusters 6] [--input_width 352] \\
      [--input_height 352] [--seed S]
"""

from __future__ import annotations

import argparse
import sys

from fastdet_torch.anchors import generate_anchors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--traintxt", default="", help="path to traintxt")
    parser.add_argument("--output_dir", default="./", type=str,
                        help="Output anchor directory")
    parser.add_argument("--num_clusters", default=6, type=int,
                        help="number of clusters")
    parser.add_argument("--input_width", default=352, type=int,
                        help="model input width")
    parser.add_argument("--input_height", default=352, type=int,
                        help="model input height")
    parser.add_argument("--seed", default=None, type=int,
                        help="k-means init seed (default: nondeterministic)")
    opt = parser.parse_args(argv)
    generate_anchors(opt.traintxt, opt.output_dir, opt.num_clusters,
                     opt.input_width, opt.input_height, seed=opt.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
