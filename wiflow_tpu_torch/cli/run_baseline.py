"""CLI entry point: train a baseline model on the Setting-1 WiFlow dataset.

Counterpart of ``wiflow_tpu/cli/run_baseline.py``, flag for flag with the
same defaults, plus ``--device``: ``cuda`` (the default; it raises where
there is no card) or ``cpu``.  One engine (``train/loop.py``) covers the
reference's four baseline scripts (ref baseline/{HPELI/hpeli.py,
WiSPPN/wisppn.py, PerUnet/perunet.py, WPformer/model.py}):

  hpeli     direct keypoints, AdamW + plateau       (hpeli.py:1361-1373)
  wisppn    PAM labels, Adam + MultiStepLR           (wisppn.py:953-955)
  perunet   PAM labels, Adam + MultiStepLR           (perunet.py:1021-1022)
  wpformer  PAM labels, SGD(0.9) + linear LambdaLR   (model.py:931-942)

PAM labels come from ``--pam_root`` (the reference's ``wisppn_labels{N}``
``.mat`` files) or, without it, are made from the keypoints (diagonal =
coordinates, unit confidence; a notice says so), so that every baseline
runs on any keypoint dataset.  Each model is built at its published
widths; fp32 runs use full-precision fp32 products (no TF32), as the JAX
baselines' ``Precision.HIGHEST`` does.  It trains data-parallel over
every CUDA device (``parallel/mesh.py``; the JAX CLI's ``MeshConfig()``),
one process on the CPU.

Usage:
  python -m wiflow_tpu_torch.cli.run_baseline --model hpeli --epochs 50 \\
      --data_dir preprocessed_csi_data --output_dir baseline_out
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from wiflow_tpu_torch.cli.run import set_seed
from wiflow_tpu_torch.core.config import (
    Config, MeshConfig, OptimConfig, TrainConfig, exact_fp32, resolve_device,
)
from wiflow_tpu_torch.data.dataset import CSIKeypointsDataset
from wiflow_tpu_torch.data.pam import (
    keypoints_to_pam, load_pam_labels_for_windows, pam_train_kwargs,
)
from wiflow_tpu_torch.data.splits import expand_to_samples, file_level_split
from wiflow_tpu_torch.data.synthetic import make_preprocessed_dataset
from wiflow_tpu_torch.eval.artifacts import write_all_artifacts
from wiflow_tpu_torch.models.baselines import (
    HPELiNet, PerUnet, WiSPPN, WPformer,
)
from wiflow_tpu_torch.parallel import mesh
from wiflow_tpu_torch.train.loop import train_pose_model

BASELINE_SPECS = {
    "hpeli": dict(labels="keypoints", kind="adamw", schedule="plateau",
                  lr=1e-4, weight_decay=5e-5),
    "wisppn": dict(labels="pam", kind="adam", schedule="multistep",
                   lr=1e-3, milestones=(10, 15, 20, 25, 30), gamma=0.5),
    "perunet": dict(labels="pam", kind="adam", schedule="multistep",
                    lr=1e-3, milestones=(10, 20, 30, 40), gamma=0.5),
    # wpformer outputs KEYPOINTS [B, K, 2]; its PAM labels supply the
    # diagonal coords + confidence of a keypoint MSE (model.py:968-974)
    "wpformer": dict(labels="pam", pam_target="keypoints", kind="sgd",
                     schedule="linear_decay", lr=1e-3, decay_start=20,
                     decay_end=50),
}
_MODELS = {"hpeli": HPELiNet, "wisppn": WiSPPN, "perunet": PerUnet,
           "wpformer": WPformer}


def build_model(name: str, compute_dtype: str = "bfloat16", *, device=None,
                seed: int = 42) -> torch.nn.Module:
    """The baseline ``name`` at its published widths on ``device`` (CUDA
    unless ``"cpu"``), its weights drawn from ``seed``."""
    if name not in _MODELS:
        raise ValueError(name)
    model = _MODELS[name](compute_dtype=compute_dtype, device=device,
                          generator=torch.Generator().manual_seed(seed))
    if hasattr(model, "dropout_generator"):
        model.dropout_generator.manual_seed(seed)
    return model


def optim_config(spec: dict, lr: float, epochs: int, kind=None
                 ) -> OptimConfig:
    """The optimizer and schedule of a baseline spec (``kind`` overrides
    the spec's optimizer family)."""
    return OptimConfig(
        lr=lr, kind=kind or spec["kind"], schedule=spec["schedule"],
        weight_decay=spec.get("weight_decay", 0.0),
        milestones=spec.get("milestones", (20, 40)),
        gamma=spec.get("gamma", 0.1),
        decay_start=spec.get("decay_start", 20),
        decay_end=spec.get("decay_end", epochs))


PAM_NOTICE = "\n".join((
    "=" * 70,
    "NOTICE: no --pam_root given; PAM labels are SYNTHESIZED from keypoints",
    "(diagonal = coords, off-diagonals = pairwise midpoints, confidence = 1).",
    "Results are NOT comparable to runs on the real wisppn_labels{N} matrices",
    "(ref baseline/WiSPPN/wisppn.py:978-1000).",
    "=" * 70))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Baseline training "
                                            "(PyTorch/CUDA)")
    p.add_argument("--model", choices=sorted(BASELINE_SPECS), required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=None,
                   help="override the baseline's reference lr")
    p.add_argument("--output_dir", type=str, default="baseline_outputs")
    p.add_argument("--data_dir", type=str, default="preprocessed_csi_data")
    p.add_argument("--pam_root", type=str, default=None,
                   help="root of wisppn_labels{N} PAM .mat dirs; synthetic "
                        "PAMs from keypoints when absent")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--patience", type=int, default=50,
                   help="baselines run fixed-epoch schedules; early stop "
                        "off by default")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16",
                   help="forward-pass compute dtype (parameters stay fp32)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train: the CUDA card (default) or the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    world = mesh.resolve_world(None, args.device)
    return mesh.run(_main, world, args.device, args)


def _main(args) -> int:
    """The run, in each rank: data-parallel over every CUDA device, as the
    JAX CLI's ``MeshConfig()`` (one process on the CPU)."""
    set_seed(args.seed)
    exact_fp32()
    dev = resolve_device(args.device)
    spec = BASELINE_SPECS[args.model]

    data_dir = args.data_dir
    with mesh.main_first():
        if args.synthetic and not os.path.exists(
                os.path.join(data_dir, "csi_windows.npy")):
            root = os.path.dirname(os.path.abspath(data_dir)) or "."
            data_dir = make_preprocessed_dataset(root, num_files=20,
                                                 frames_per_file=200)
    if not os.path.exists(os.path.join(data_dir, "csi_windows.npy")):
        print(f"error: no preprocessed artifacts in {data_dir!r}",
              file=sys.stderr)
        return 2

    dataset = CSIKeypointsDataset(data_dir)
    tr, va, te = file_level_split(dataset.num_files, seed=args.seed)
    use_pam = spec["labels"] == "pam"
    parts = {}
    for name, files in (("train", tr), ("val", va), ("test", te)):
        idx = expand_to_samples(dataset.window_ranges, files)
        csi, kp = dataset.materialize(idx)
        if use_pam:
            if args.pam_root:
                kp = load_pam_labels_for_windows(
                    args.pam_root, dataset.keypoints_files,
                    dataset.window_to_file, dataset.window_to_frame, idx)
            else:
                if name == "train":
                    print(PAM_NOTICE)
                kp = keypoints_to_pam(kp)
        parts[name] = (csi, kp)
        print(f"[split] {name}: {len(idx)} samples")

    lr = args.lr if args.lr is not None else spec["lr"]
    cfg = Config(
        train=TrainConfig(batch_size=args.batch_size, num_epochs=args.epochs,
                          patience=args.patience, seed=args.seed,
                          optim=optim_config(spec, lr, args.epochs)),
        mesh=MeshConfig(), output_dir=args.output_dir)
    model = build_model(args.model, args.compute_dtype, device=dev,
                        seed=args.seed)
    result = train_pose_model(parts["train"], parts["val"], parts["test"],
                              cfg, args.output_dir, model=model,
                              resume=not args.no_resume,
                              **pam_train_kwargs(spec))
    if not mesh.is_main():
        return 0
    write_all_artifacts(result, args.output_dir)
    print("[timings] " + json.dumps(result.timings))
    print(f"[done] {args.model}: test MPJPE {result.test_metrics['mpe']:.4f}"
          f" m, PCK@20 {result.test_metrics['pck@0.2'] * 100:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
