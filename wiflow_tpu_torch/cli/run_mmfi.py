"""CLI entry point: train WiFlow on MM-Fi (Setting 3, cross-dataset).

Counterpart of ``wiflow_tpu/cli/run_mmfi.py``, flag for flag with the same
defaults (ref cross_dataset_test/WiFlow/wiflow.py:1749-1904), plus
``--device``: ``cuda`` (the default; it raises where there is no card) or
``cpu``.  The MM-Fi splits come from a YAML config (``--config``, which
needs PyYAML) over the reference's ``config.yaml`` defaults; the
validation subjects are split 50/50 into val and test (random_state 41);
the trainer stops early and lowers the lr on the largest val PCK
(:1225-1247), with AdamW at weight decay 1e-4 (:1218-1221), root-relative
metrics, and resume from ``latest_checkpoint.pkl`` in ``--output_dir``
unless ``--no_resume``.  ``--model`` takes ``wiflow`` or one of the four
baselines re-targeted to MM-Fi (ref cross_dataset_test/): ``hpeli``
regresses the 2-D projection of the 17 keypoints, ``wpformer`` the 3-D
keypoints under a mask of the keypoints whose ground truth exists
(metafi.py:750-753), ``perunet`` the 3-D keypoints, ``wisppn`` a 3x17x17
PAM under the confidence-weighted MSE, scored on its diagonal.  It trains
data-parallel over every CUDA device (``parallel/mesh.py``; the JAX CLI's
``MeshConfig()``), one process on the CPU.

Usage:
  python -m wiflow_tpu_torch.cli.run_mmfi --dataset_root /data/MMFi \\
      --config config.yaml --epochs 50 --batch_size 64
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from wiflow_tpu_torch.cli.run import set_seed
from wiflow_tpu_torch.core.config import (
    MMFI_SKELETON_CONNECTIONS, Config, MeshConfig, OptimConfig, TrainConfig,
    exact_fp32, resolve_device,
)
from wiflow_tpu_torch.data.mmfi import (
    generate_synthetic_mmfi, make_dataset, split_val_test,
)
from wiflow_tpu_torch.eval.artifacts import write_all_artifacts
from wiflow_tpu_torch.data.pam import (
    keypoints_to_pam, pam_confidence_mse, pam_to_keypoints,
)
from wiflow_tpu_torch.metrics.mmfi_metrics import (
    root_aligned_mpjpe, root_relative_pck_fractions,
)
from wiflow_tpu_torch.models.baselines import (
    HPELiMMFi, PerUnetMMFi, WiSPPN, wpformer_mmfi,
)
from wiflow_tpu_torch.models.wiflow_mmfi import (
    MMFiModelConfig, WiFlowMMFiModel,
)
from wiflow_tpu_torch.parallel import mesh
from wiflow_tpu_torch.train.loop import train_pose_model

DEFAULT_CONFIG = {
    # the defaults of the reference's HPE-Li/dataset_lib/config.yaml
    "modality": "wifi-csi",
    "protocol": "protocol3",
    "data_unit": "frame",
    "split_to_use": "random_split",
    "random_split": {"ratio": 0.7, "random_seed": 0},
    "init_rand_seed": 0,
}


def metafi_masked_mse(out: torch.Tensor, yb: torch.Tensor):
    """WPformer's MM-Fi loss: the MSE over the keypoints whose ground
    truth exists (ref cross_dataset_test/WPformer/metafi.py:750-753)."""
    mask = (yb.abs().sum(dim=-1, keepdim=True) > 1e-5).float()
    loss = ((out.float() * mask - yb.float() * mask) ** 2).mean()
    return loss, {"position": loss, "bone": torch.zeros_like(loss)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WiFlow on MM-Fi (PyTorch/CUDA)")
    p.add_argument("--dataset_root", type=str, default="MMFi")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config (protocol/split; needs PyYAML); the "
                        "defaults are the reference's config.yaml")
    p.add_argument("--model", default="wiflow",
                   choices=["wiflow", "hpeli", "wisppn", "perunet",
                            "wpformer"],
                   help="wiflow (default) or a baseline re-targeted to "
                        "MM-Fi")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--output_dir", type=str, default="mmfi_outputs")
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--plateau_patience", type=int, default=3,
                   help="ReduceLROnPlateau patience in epochs (ref "
                        "cross_dataset_test/WiFlow/wiflow.py:1225-1233 "
                        "uses 3, for real MM-Fi epochs of thousands of "
                        "steps; raise it for small synthetic trees)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", action="store_true",
                   help="generate a miniature synthetic MM-Fi tree if the "
                        "dataset_root is missing")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--no_videos", action="store_true")
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
    if args.model != "wiflow":
        exact_fp32()
    dev = resolve_device(args.device)

    config = dict(DEFAULT_CONFIG)
    if args.config:
        import yaml
        with open(args.config, "r", encoding="utf-8") as fd:
            config.update(yaml.safe_load(fd))

    with mesh.main_first():
        if args.synthetic and not os.path.isdir(args.dataset_root):
            print(f"[synthetic] generating miniature MM-Fi at "
                  f"{args.dataset_root}")
            generate_synthetic_mmfi(args.dataset_root,
                                    subjects=("S01", "S02", "S11"),
                                    actions=("A01", "A02"), frames=48)

        if not os.path.isdir(args.dataset_root):
            print(f"error: MM-Fi root {args.dataset_root!r} not found "
                  f"(pass --synthetic for a test tree)", file=sys.stderr)
            return 2

        train_ds, val_ds = make_dataset(args.dataset_root, config)
        print(f"[data] train {len(train_ds)} frames, val+test {len(val_ds)}")
        os.makedirs(args.output_dir, exist_ok=True)
        train_xy = train_ds.materialize(
            os.path.join(args.output_dir, "mmfi_train_cache.npz"))
        val_all = val_ds.materialize(
            os.path.join(args.output_dir, "mmfi_val_cache.npz"))
    vi, ti = split_val_test(len(val_ds))
    val_xy = (val_all[0][vi], val_all[1][vi])
    test_xy = (val_all[0][ti], val_all[1][ti])
    print(f"[split] train {len(train_xy[0])} / val {len(val_xy[0])} / "
          f"test {len(test_xy[0])}")

    cfg = Config(
        train=TrainConfig(
            batch_size=args.batch_size, num_epochs=args.epochs,
            patience=args.patience, seed=args.seed,
            optim=OptimConfig(lr=args.lr, weight_decay=1e-4,
                              plateau_patience=args.plateau_patience)),
        mesh=MeshConfig(), output_dir=args.output_dir,
    )
    # the model's labels and loss (ref cross_dataset_test/): wiflow,
    # wpformer and perunet regress 17x3 keypoints; hpeli the 2-D
    # projection (HPE-Li/model/HPE_no_denoiser.py); wisppn a 3x17x17 PAM
    kwargs = dict(connections=MMFI_SKELETON_CONNECTIONS,
                  pck_fn=root_relative_pck_fractions,
                  mpe_fn=root_aligned_mpjpe, monitor="pck")
    dt, gen = args.compute_dtype, torch.Generator().manual_seed(args.seed)
    if args.model == "wiflow":
        model = WiFlowMMFiModel(MMFiModelConfig(compute_dtype=dt),
                                device=dev, generator=gen)
    elif args.model == "hpeli":
        model = HPELiMMFi(compute_dtype=dt, device=dev, generator=gen)
        train_xy, val_xy, test_xy = ((x, y[..., :2]) for x, y in
                                     (train_xy, val_xy, test_xy))
    elif args.model == "wpformer":
        model = wpformer_mmfi(dt, device=dev, generator=gen)
        model.dropout_generator.manual_seed(args.seed)
        kwargs.update(loss_fn=metafi_masked_mse)
    elif args.model == "perunet":
        model = PerUnetMMFi(compute_dtype=dt, device=dev, generator=gen)
    else:                                        # wisppn: PAM targets
        model = WiSPPN(input_converter="mmfi", pam_channels=3, pam_size=17,
                       compute_dtype=dt, device=dev, generator=gen)
        train_xy, val_xy, test_xy = ((x, keypoints_to_pam(y)) for x, y in
                                     (train_xy, val_xy, test_xy))
        kwargs.update(loss_fn=pam_confidence_mse,
                      to_keypoints=pam_to_keypoints)
    result = train_pose_model(
        train_xy, val_xy, test_xy, cfg, args.output_dir, model=model,
        resume=not args.no_resume, **kwargs)
    if not mesh.is_main():
        return 0
    paths = write_all_artifacts(result, args.output_dir,
                                make_videos=not args.no_videos,
                                connections=MMFI_SKELETON_CONNECTIONS)
    print("[artifacts] " + ", ".join(sorted(paths)))
    print("[timings] " + json.dumps(result.timings))
    print(f"[done] best epoch {result.best_epoch + 1}, "
          f"test MPJPE {result.test_metrics['mpe']:.4f} m, "
          f"PCK@20 {result.test_metrics['pck@0.2'] * 100:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
