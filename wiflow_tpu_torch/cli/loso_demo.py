"""Setting-2 LOSO demonstration: 5-fold cross-subject training.

Counterpart of ``wiflow_tpu/cli/loso_demo.py``, flag for flag with its
defaults plus ``--device`` (``cuda``, the default, or ``cpu``).  Each
subject has a movement style of its own over shared CSI physics
(``cli/convergence_demo.py::synth_windows(subject=s)``, drawn on the
device); each fold trains on the other subjects (85/15 train/val each)
with the reference recipe and tests on the held-out one.  Writes
``loso_summary.json`` and ``loso_table.md``, with the JAX demo's keys and
rows.

Usage:
  python -m wiflow_tpu_torch.cli.loso_demo --per_subject 20000 \\
      --epochs 12 --output_dir measured/loso
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from wiflow_tpu_torch.cli.convergence_demo import synth_windows
from wiflow_tpu_torch.core.config import (
    Config, MeshConfig, OptimConfig, TrainConfig, resolve_device,
)
from wiflow_tpu_torch.train.loop import train_pose_model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="5-fold LOSO measured run")
    p.add_argument("--per_subject", type=int, default=20_000)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--subjects", type=int, default=5)
    p.add_argument("--folds", type=int, nargs="+", default=None,
                   help="subset of folds to run (default: all subjects)")
    p.add_argument("--output_dir", type=str, default="measured/loso")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train: the CUDA card (default) or the CPU")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    subjects = list(range(1, args.subjects + 1))
    folds = args.folds or subjects
    os.makedirs(args.output_dir, exist_ok=True)

    print(f"[data] generating {args.per_subject} windows x "
          f"{len(subjects)} subjects on-device")
    per_subject = {s: synth_windows(args.per_subject, args.seed + 1000 * s,
                                    subject=s, device=dev)
                   for s in subjects}

    rows = []
    for s in folds:
        fold_dir = os.path.join(args.output_dir, f"subject_{s}")
        os.makedirs(fold_dir, exist_ok=True)
        trains_x, trains_y, vals_x, vals_y = [], [], [], []
        for o in subjects:
            if o == s:
                continue
            x, y = per_subject[o]
            n_tr = int(len(x) * 0.85)
            trains_x.append(x[:n_tr])
            trains_y.append(y[:n_tr])
            vals_x.append(x[n_tr:])
            vals_y.append(y[n_tr:])
        train = (torch.cat(trains_x), torch.cat(trains_y))
        val = (torch.cat(vals_x), torch.cat(vals_y))
        test = per_subject[s]

        cfg = Config(
            train=TrainConfig(batch_size=args.batch_size,
                              num_epochs=args.epochs, patience=5,
                              seed=args.seed, data_dtype="bfloat16",
                              optim=OptimConfig(lr=args.lr,
                                                weight_decay=5e-5)),
            mesh=MeshConfig(num_devices=1), output_dir=fold_dir)

        t0 = time.time()
        result = train_pose_model(train, val, test, cfg, fold_dir,
                                  resume=False, device=dev)
        del train, val
        wall = time.time() - t0
        tm = result.test_metrics
        row = {
            "subject": s,
            "pck20": round(float(tm["pck@0.2"]) * 100, 2),
            "pck30": round(float(tm["pck@0.3"]) * 100, 2),
            "pck50": round(float(tm["pck@0.5"]) * 100, 2),
            "mpjpe_m": round(float(tm["mpe"]), 4),
            "epochs_run": result.epochs_run,
            "best_epoch": result.best_epoch + 1,
            "wall_clock_min": round(wall / 60, 2),
        }
        rows.append(row)
        print(f"[fold S{s}] PCK@20 {row['pck20']}% PCK@30 {row['pck30']}% "
              f"PCK@50 {row['pck50']}% MPJPE {row['mpjpe_m']} m "
              f"({row['wall_clock_min']} min)")

    avg = {k: round(float(np.mean([r[k] for r in rows])), 4)
           for k in ("pck20", "pck30", "pck50", "mpjpe_m",
                     "wall_clock_min")}
    summary = {
        "per_subject_windows": args.per_subject,
        "epochs": args.epochs,
        "folds": rows,
        "average": avg,
        "reference_table": "README.md:141-188 (5-fold avg "
                           "87.26/94.01/97.69 PCK@20/30/50, MPJPE 0.019)",
    }
    out = os.path.join(args.output_dir, "loso_summary.json")
    with open(out, "w", encoding="utf-8") as fd:
        json.dump(summary, fd, indent=2)

    md = ["| Test subject | PCK@20 | PCK@30 | PCK@50 | MPJPE (m) | "
          "Wall clock (min) |",
          "|---|---|---|---|---|---|"]
    for r in rows:
        md.append(f"| Subject {r['subject']} | {r['pck20']} | {r['pck30']} |"
                  f" {r['pck50']} | {r['mpjpe_m']} | {r['wall_clock_min']} |")
    md.append(f"| **Average** | **{avg['pck20']}** | **{avg['pck30']}** | "
              f"**{avg['pck50']}** | **{avg['mpjpe_m']}** | "
              f"**{avg['wall_clock_min']}** |")
    with open(os.path.join(args.output_dir, "loso_table.md"), "w",
              encoding="utf-8") as fd:
        fd.write("\n".join(md) + "\n")
    print(f"[done] summary -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
