"""CLI entry point: train WiFlow on preprocessed 540x20 CSI windows.

Counterpart of ``wiflow_tpu/cli/run.py``, flag for flag with the same
defaults (ref run.py:32-41, with ``--output_dir``, ``--data_dir`` and
``--use_augmentation`` honoured, LOSO splits and a synthetic bootstrap),
plus ``--device``: ``cuda`` (the default; it raises where there is no
card) or ``cpu``.  It trains (resuming from ``latest_checkpoint.pkl`` in
``--output_dir`` unless ``--no_resume``), then writes the artifacts of
``eval/artifacts.py``.

Usage:
  python -m wiflow_tpu_torch.cli.run --epochs 50 --batch_size 64 \\
      --data_dir preprocessed_csi_data --output_dir outputs
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import sys

import numpy as np
import torch

from wiflow_tpu_torch.core.config import (
    Config, DataConfig, ModelConfig, OptimConfig, TrainConfig, resolve_device,
)
from wiflow_tpu_torch.data.dataset import CSIKeypointsDataset
from wiflow_tpu_torch.data.splits import (
    expand_to_samples, file_level_split, infer_subject, loso_split,
)
from wiflow_tpu_torch.data.synthetic import make_preprocessed_dataset
from wiflow_tpu_torch.eval.artifacts import write_all_artifacts
from wiflow_tpu_torch.train.loop import train_pose_model


def set_seed(seed: int = 42) -> None:
    """Seed Python, numpy and torch, and make cuDNN deterministic (ref
    run.py:18-26); the trainer seeds its own generators from the seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WiFlow training (PyTorch/CUDA)")
    p.add_argument("--gpu", type=str, default="auto",
                   help="device count: 'auto' or 1 (kept for reference-CLI "
                        "compatibility; multi-GPU training is not ported)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=5e-5)
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--use_augmentation", action="store_true")
    p.add_argument("--data_dir", type=str, default="preprocessed_csi_data")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--split", choices=["random", "loso"], default="random")
    p.add_argument("--test_subject", type=int, default=1,
                   help="held-out subject for --split loso (Setting 2)")
    p.add_argument("--subject_map", type=str, default=None,
                   help="JSON file mapping file_id -> subject int; "
                        "overrides the file-name-based inference for "
                        "--split loso")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic dataset into --data_dir if "
                        "the artifacts are missing")
    p.add_argument("--no_videos", action="store_true")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--grad_accum_steps", type=int, default=1)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here "
                        "(trace.json, for chrome://tracing or Perfetto)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: fail at the op "
                        "whose backward produced a NaN")
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16",
                   help="forward-pass compute dtype (parameters stay fp32)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train: the CUDA card (default) or the CPU")
    return p


def _device_count(gpu: str) -> int:
    """The JAX CLI's reading of ``--gpu``: 'auto' or '' for all devices,
    else the first comma-separated number (0 counts as 1)."""
    if gpu in ("auto", ""):
        return 1
    try:
        return max(1, int(gpu.split(",")[0]) or 1)
    except ValueError:
        return 1


@contextlib.contextmanager
def _profiled(profile_dir):
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if _device_count(args.gpu) != 1:
        raise SystemExit(f"--gpu {args.gpu}: multi-GPU training is not "
                         f"ported; run on one device")
    set_seed(args.seed)
    torch.autograd.set_detect_anomaly(args.debug_nans)
    dev = resolve_device(args.device)
    data_dir = args.data_dir
    if args.synthetic and not os.path.exists(
            os.path.join(data_dir, "csi_windows.npy")):
        print(f"[synthetic] generating dataset under {data_dir}/..")
        root = os.path.dirname(os.path.abspath(data_dir)) or "."
        made = make_preprocessed_dataset(root, num_files=20,
                                         frames_per_file=200)
        if os.path.abspath(made) != os.path.abspath(data_dir):
            data_dir = made

    if not os.path.exists(os.path.join(data_dir, "csi_windows.npy")):
        print(f"error: no preprocessed artifacts in {data_dir!r}. Run "
              f"python -m wiflow_tpu_torch.cli.preprocess on your raw "
              f"recordings, or pass --synthetic.", file=sys.stderr)
        return 2

    dataset = CSIKeypointsDataset(data_dir)
    print(f"[data] {len(dataset)} windows from {dataset.num_files} files "
          f"({'npy fast' if dataset.use_npy_mode else 'csv'} mode)")

    if args.split == "loso":
        if args.subject_map:
            with open(args.subject_map, "r", encoding="utf-8") as fd:
                smap = json.load(fd)
            subjects = [int(smap[f]) for f in dataset.file_ids]
        else:
            subjects = [infer_subject(f) for f in dataset.file_ids]
        tr, va, te = loso_split(subjects, args.test_subject, seed=args.seed)
        print(f"[split] LOSO: test subject {args.test_subject} "
              f"({len(te)} files)")
    else:
        tr, va, te = file_level_split(dataset.num_files, seed=args.seed)
        print(f"[split] random file-level: {len(tr)}/{len(va)}/{len(te)} "
              f"files")

    parts = {}
    for name, files in (("train", tr), ("val", va), ("test", te)):
        idx = expand_to_samples(dataset.window_ranges, files)
        parts[name] = dataset.materialize(idx)
        print(f"[split] {name}: {len(idx)} samples")

    # one-batch smoke check (ref run.py:94-101)
    xb, yb = parts["train"][0][:8], parts["train"][1][:8]
    if not (np.isfinite(xb).all() and np.isfinite(yb).all()):
        raise ValueError("NaN/Inf in the first training batch")
    print(f"[smoke] batch x{xb.shape} y{yb.shape} ok")

    cfg = Config(
        data=DataConfig(data_dir=data_dir),
        model=ModelConfig(compute_dtype=args.compute_dtype),
        train=TrainConfig(
            batch_size=args.batch_size, num_epochs=args.epochs,
            patience=args.patience, use_augmentation=args.use_augmentation,
            seed=args.seed, grad_accum_steps=args.grad_accum_steps,
            optim=OptimConfig(lr=args.lr, weight_decay=args.weight_decay)),
        output_dir=args.output_dir,
    )
    with _profiled(args.profile_dir):
        result = train_pose_model(parts["train"], parts["val"], parts["test"],
                                  cfg, args.output_dir,
                                  resume=not args.no_resume, device=dev)
    paths = write_all_artifacts(result, args.output_dir,
                                make_videos=not args.no_videos)
    print("[artifacts] " + ", ".join(sorted(paths)))
    print("[timings] " + json.dumps(result.timings))
    print(f"[done] best epoch {result.best_epoch + 1}, "
          f"test MPJPE {result.test_metrics['mpe']:.4f} m, "
          f"PCK@20 {result.test_metrics['pck@0.2'] * 100:.2f}%, "
          f"wall clock {result.wall_clock_sec:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
