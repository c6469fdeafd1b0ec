"""CLI entry: produce the preprocessed CSI artifact set from raw recordings.

Counterpart of ``wiflow_tpu/cli/preprocess.py``, flag for flag: windowing,
the window and file maps, the 25 -> 15 keypoint filter, the /1000 scaling
and the fast-path keypoint arrays, in one pass
(``data/preprocess.py::preprocess_csi_data``).

Usage:
  python -m wiflow_tpu_torch.cli.preprocess --raw_dir recordings/ \\
      --output_dir preprocessed_csi_data [--window_size 20] [--stride 1]

Raw inputs: per-recording ``<id>_csi.npy`` [T, 540] amplitude arrays +
``<id>_keypoints.csv`` (25 OpenPose (x, y) pairs per row, millimetres).
"""

from __future__ import annotations

import argparse
import sys

from wiflow_tpu_torch.data.preprocess import preprocess_csi_data


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Window raw CSI recordings into training artifacts")
    p.add_argument("--raw_dir", type=str, required=True,
                   help="directory of <id>_csi.npy + <id>_keypoints.csv pairs")
    p.add_argument("--output_dir", type=str, default="preprocessed_csi_data")
    p.add_argument("--window_size", type=int, default=20)   # ref config.py:7
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--keypoint_scale", type=float, default=1000.0,
                   help="divide keypoint mm coordinates by this "
                        "(ref dataset.py:144)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    stats = preprocess_csi_data(
        args.raw_dir, args.output_dir, window_size=args.window_size,
        stride=args.stride, keypoint_scale=args.keypoint_scale)
    print(f"[preprocess] {stats['num_files']} files -> "
          f"{stats['num_windows']} windows ({stats['num_frames']} frames) "
          f"in {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
