"""CLI entry point: the HPE-Li robustness experiments.

Counterpart of ``wiflow_tpu/cli/run_robustness.py``, flag for flag with the
same defaults (ref cross_dataset_test/HPE-Li/main.py:24-250 and constant.py's
modes, and the DSKNetTrans trainers att_mmfi.py:427 / att_wipose.py:340),
plus ``--device``: ``cuda`` (the default; it raises where there is no card)
or ``cpu``.

  mode 0  train and evaluate on clean CSI,
  mode 1  pre-train a stacked denoising AE at each noise level, stage by
          stage (denoiser_training.py), then train DenoiserHPE end to end,
          as the reference does (main.py:65-67); ``--freeze_denoiser``
          freezes the pretrained encoder instead,
  mode 2  corrupt the CSI with AWGN and clean it with a traditional filter
          (traditional_filter/{gaussian,mean}_filter.py), on the device.

The reference's recipe: confidence-weighted MSE / 32, the "confidence"
being the keypoints' third channel (main.py:125-131), plain SGD at lr 1e-3
(momentum 0, no clip, main.py:67) with a linear decay from epoch 20 to 50
(main.py:68-76), the best weights by the largest val PCK@20
(main.py:258-268), PCKh over keypoints 1 and 11 (MM-Fi; 6 and 13 for
WiPose), MPJPE and PA-MPJPE.  After training, each level's run is swept
over the clean test split and the split at that level.

Models: ``original_hpe``, ``dsknet_trans`` (DSKNetTransMMFi), ``basic_cnn``,
``denoiser_hpe`` (implies mode 1); WiPose: ``hpe_wipose``,
``dsknet_trans_wipose``.  They are fp32 (TF32 off), but DenoiserHPE, whose
input is bf16 as in the JAX package.  ``--devices N`` trains each model
data-parallel on N ranks (``parallel/mesh.py``), which the command starts
itself (one a CUDA device; more than there are raises; with ``--device
cpu``, gloo processes); every rank repeats mode 1's pre-training of the
autoencoders by itself, and rank 0 alone writes.  ``--no_scan`` is
accepted and changes nothing: the port's epochs are eager.  ``--config``
needs PyYAML.

Usage:
  python -m wiflow_tpu_torch.cli.run_robustness --model original_hpe \\
      --mode 0 --dataset_root mmfi_data --synthetic --epochs 5
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from wiflow_tpu_torch.cli.run import set_seed
from wiflow_tpu_torch.cli.run_mmfi import DEFAULT_CONFIG
from wiflow_tpu_torch.core.config import (
    Config, MeshConfig, OptimConfig, TrainConfig, exact_fp32, resolve_device,
)
from wiflow_tpu_torch.data.mmfi import (
    generate_synthetic_mmfi, make_dataset, split_val_test,
)
from wiflow_tpu_torch.data.wipose import (
    WiPoseDataset, generate_synthetic_wipose,
)
from wiflow_tpu_torch.metrics.metrics import pckh_fractions_fn
from wiflow_tpu_torch.models.baselines import hpeli_zoo
from wiflow_tpu_torch.parallel import mesh
from wiflow_tpu_torch.robustness.denoiser import (
    DenoiserHPE, merge_denoiser, train_denoiser_stage,
)
from wiflow_tpu_torch.robustness.evaluate import FILTERS, evaluate_robustness
from wiflow_tpu_torch.robustness.noise import (
    add_awgn, add_awgn_torch, add_salt_and_pepper_torch,
)
from wiflow_tpu_torch.train.loop import train_pose_model

MMFI_MODELS = ("original_hpe", "dsknet_trans", "basic_cnn", "denoiser_hpe")
WIPOSE_MODELS = ("hpe_wipose", "dsknet_trans_wipose")
_ZOO = {"original_hpe": hpeli_zoo.OriginalHPE,
        "dsknet_trans": hpeli_zoo.DSKNetTransMMFi,
        "basic_cnn": hpeli_zoo.BasicCnnHPE,
        "hpe_wipose": hpeli_zoo.HPEWiPoseModel,
        "dsknet_trans_wipose": hpeli_zoo.DSKNetTransWipose}


def build_model(name: str, num_stages: int = 5, *, device=None,
                seed: int = 0) -> torch.nn.Module:
    """The model ``name`` on ``device`` (CUDA unless ``"cpu"``), its
    weights drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if name == "denoiser_hpe":
        model = DenoiserHPE(num_stages=num_stages, device=device,
                            generator=gen)
    elif name in _ZOO:
        model = _ZOO[name](device=device, generator=gen)
    else:
        raise ValueError(name)
    model.dropout_generator.manual_seed(seed)
    return model


def conf_weighted_mse(out: torch.Tensor, yb: torch.Tensor):
    """criterion_L2(conf * pred, conf * xy) / 32 (ref main.py:125-131)."""
    conf = yb[..., 2:3].float()
    xy = yb[..., :2].float()
    loss = ((conf * out.float() - conf * xy) ** 2).mean() / 32.0
    return loss, {"position": loss, "bone": torch.zeros_like(loss)}


def to_xy_keypoints(out: torch.Tensor, yb: torch.Tensor):
    return out, yb[..., :2]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HPE-Li robustness harness "
                                            "(PyTorch/CUDA)")
    p.add_argument("--model", choices=MMFI_MODELS + WIPOSE_MODELS,
                   default="original_hpe")
    p.add_argument("--mode", type=int, choices=(0, 1, 2), default=0,
                   help="0 none / 1 AE denoiser / 2 traditional filter")
    p.add_argument("--noise_levels", type=float, nargs="+", default=[0.0])
    p.add_argument("--noise_kind", choices=("awgn", "salt_pepper"),
                   default="awgn")
    p.add_argument("--filter", choices=("gaussian", "mean"),
                   default="gaussian")
    p.add_argument("--denoiser_stages", type=int, default=5)
    p.add_argument("--denoiser_epochs", type=int, default=5)
    p.add_argument("--freeze_denoiser", action="store_true",
                   help="freeze the pretrained AE encoder during mode-1 "
                        "HPE training (the reference trains end to end, "
                        "main.py:65-67)")
    p.add_argument("--dataset_root", type=str, default="mmfi_data")
    p.add_argument("--wipose_root", type=str, default="wipose_data")
    p.add_argument("--config", type=str, default=None,
                   help="MM-Fi protocol/split YAML (needs PyYAML)")
    p.add_argument("--output_dir", type=str, default="robustness_outputs")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=60)     # constant.py epoch
    p.add_argument("--lr", type=float, default=1e-3)     # main.py:67
    p.add_argument("--optimizer", choices=("sgd", "adam"), default=None,
                   help="default: adam for the DSKNetTrans trainers "
                        "(att_mmfi.py:86), sgd otherwise (main.py:67)")
    p.add_argument("--patience", type=int, default=10 ** 6,
                   help="the reference runs fixed epochs; no early stop")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=None,
                   help="ranks of data-parallel training (default: every "
                        "CUDA device)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_frames", type=int, default=48)
    p.add_argument("--synthetic_learnable", action="store_true",
                   help="derive synthetic CSI from the GT poses (one "
                        "fixed mixing map) so the model can actually "
                        "learn — use for measured sweeps")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--no_scan", action="store_true",
                   help="accepted for the JAX CLI's command lines; the "
                        "port's epochs are per-batch steps already")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train: the CUDA card (default) or the CPU")
    return p


def _load_mmfi(args):
    config = dict(DEFAULT_CONFIG)
    if args.config:
        import yaml
        with open(args.config, "r", encoding="utf-8") as fd:
            config.update(yaml.safe_load(fd))
    with mesh.main_first():
        if args.synthetic and not os.path.isdir(args.dataset_root):
            print(f"[synthetic] generating miniature MM-Fi at "
                  f"{args.dataset_root}")
            subs = ("S01", "S02", "S03", "S11") if args.synthetic_learnable \
                else ("S01", "S02", "S11")
            generate_synthetic_mmfi(args.dataset_root, subjects=subs,
                                    actions=("A01", "A02"),
                                    frames=args.synthetic_frames,
                                    learnable=args.synthetic_learnable)
        if not os.path.isdir(args.dataset_root):
            raise FileNotFoundError(
                f"MM-Fi root {args.dataset_root!r} not found "
                f"(pass --synthetic for a test tree)")
        train_ds, val_ds = make_dataset(args.dataset_root, config)
        os.makedirs(args.output_dir, exist_ok=True)
        train_xy = train_ds.materialize(
            os.path.join(args.output_dir, "mmfi_train_cache.npz"))
        val_all = val_ds.materialize(
            os.path.join(args.output_dir, "mmfi_val_cache.npz"))
    vi, ti = split_val_test(len(val_ds))
    return (train_xy, (val_all[0][vi], val_all[1][vi]),
            (val_all[0][ti], val_all[1][ti]))


def _load_wipose(args):
    with mesh.main_first():
        if args.synthetic and not os.path.isdir(args.wipose_root):
            generate_synthetic_wipose(args.wipose_root, per_split=64)
    train = WiPoseDataset(args.wipose_root, split="Train").materialize()
    test = WiPoseDataset(args.wipose_root, split="Test").materialize()
    n = len(test[0]) // 2
    return (train, (test[0][:n], test[1][:n]), (test[0][n:], test[1][n:]))


def _filtered(x: np.ndarray, filt, dev: torch.device) -> np.ndarray:
    """A traditional filter over a whole split, on the device (the copies
    to it and back included)."""
    return filt(torch.from_numpy(np.ascontiguousarray(x)).to(dev)).cpu() \
        .numpy()


def _pretrain_denoiser(args, train_x: np.ndarray, level: float, dev):
    """Mode 1's greedy stage-by-stage pre-training at ``level``
    (denoiser_training.py): the stack's ``state_dict``."""
    noise = (add_awgn_torch if args.noise_kind == "awgn"
             else add_salt_and_pepper_torch)
    sd = None
    for stage in range(1, args.denoiser_stages + 1):
        sd = train_denoiser_stage(
            train_x, stage, lambda x, g: noise(x, level, g),
            prev_state_dict=sd, epochs=args.denoiser_epochs,
            seed=args.seed, verbose=True, device=dev)
    return sd


def _write_history(path: str, history) -> None:
    keys = sorted(history)
    with open(path, "w", encoding="utf-8") as fd:
        fd.write(",".join(["epoch"] + keys) + "\n")
        for i in range(len(history[keys[0]])):
            fd.write(",".join([str(i + 1)] + [f"{history[k][i]:.6g}"
                                              for k in keys]) + "\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    world = mesh.resolve_world(args.devices, args.device)
    return mesh.run(_main, world, args.device, args)


def _main(args) -> int:
    """The run, in each rank."""
    set_seed(args.seed)
    exact_fp32()
    dev = resolve_device(args.device)
    if args.model == "denoiser_hpe":
        args.mode = 1

    wipose = args.model in WIPOSE_MODELS
    if wipose:
        train_xy, val_xy, test_xy = _load_wipose(args)
        pck_fn = pckh_fractions_fn(6, 13)   # 18 kp (evaluation.py:33-57)
    else:
        train_xy, val_xy, test_xy = _load_mmfi(args)
        pck_fn = pckh_fractions_fn(1, 11)   # HPE-Li eval.py:44-76
    print(f"[split] train {len(train_xy[0])} / val {len(val_xy[0])} / "
          f"test {len(test_xy[0])}")

    results = {}
    mode0_cache = None   # mode-0 training does not depend on the level
    for level in args.noise_levels:
        run_dir = os.path.join(args.output_dir,
                               f"{args.model}_mode{args.mode}_n{level}")
        os.makedirs(run_dir, exist_ok=True)

        parts = {"train": train_xy, "val": val_xy, "test": test_xy}
        if args.mode == 2 and level > 0:
            # corrupt on the host (main.py:100-105), filter on the device
            rng = np.random.default_rng(args.seed)
            for name, (x, y) in parts.items():
                noisy = add_awgn(x, level, rng)
                t0 = time.perf_counter()
                parts[name] = (_filtered(noisy, FILTERS[args.filter], dev), y)
                print(f"[filter] {args.filter} {name}: {len(x)} windows in "
                      f"{time.perf_counter() - t0:.6f} s")

        init_state_dict, frozen = None, ()
        if args.mode == 1:
            stack = _pretrain_denoiser(args, parts["train"][0], level, dev)
            init_state_dict = merge_denoiser(stack, args.denoiser_stages)
            # the reference trains the composition end to end
            # (main.py:65-67); freezing the encoder is an opt-in
            frozen = ("encoder",) if args.freeze_denoiser else ()

        opt_kind = args.optimizer or (
            "adam" if args.model.startswith("dsknet") else "sgd")
        cfg = Config(
            train=TrainConfig(
                batch_size=args.batch_size, num_epochs=args.epochs,
                patience=args.patience, patience_steps=None, seed=args.seed,
                # torch.optim.SGD's defaults at main.py:67: momentum 0, no
                # gradient clipping (nothing clips anywhere in HPE-Li)
                optim=OptimConfig(lr=args.lr, kind=opt_kind, momentum=0.0,
                                  grad_clip_norm=None,
                                  schedule="linear_decay", decay_start=20,
                                  decay_end=50, plateau_patience_steps=None)),
            mesh=MeshConfig(num_devices=args.devices), output_dir=run_dir)

        if args.mode == 0 and mode0_cache is not None:
            model, result = mode0_cache
        else:
            model = build_model(args.model, args.denoiser_stages,
                                device=dev, seed=args.seed)
            result = train_pose_model(
                parts["train"], parts["val"], parts["test"], cfg, run_dir,
                model=model, resume=not args.no_resume,
                loss_fn=conf_weighted_mse, to_keypoints=to_xy_keypoints,
                pck_fn=pck_fn, monitor="pck",
                init_state_dict=init_state_dict, frozen_params=frozen)
            if args.mode == 0:
                mode0_cache = (model, result)
            if mesh.is_main():
                _write_history(os.path.join(run_dir, "training_history.csv"),
                               result.history)

        # the post-training sweep of the test split (main.py's outer noise
        # loop evaluates the trained model at each level)
        model.eval()
        with torch.no_grad():
            sweep = evaluate_robustness(
                model, parts["test"][0], parts["test"][1][..., :2],
                noise_levels=(0.0, level) if level > 0 else (0.0,),
                noise_kind=args.noise_kind,
                cleaner=(args.filter if args.mode == 2 else "none"),
                pck_fn=pck_fn, batch_size=args.batch_size, seed=args.seed,
                device=dev)
        results[level] = {
            "test_pck20": result.test_metrics["pck@0.2"],
            "test_pck50": result.test_metrics["pck@0.5"],
            "test_mpjpe": result.test_metrics["mpe"],
            "sweep": {str(k): v for k, v in sweep.items()},
        }
        print(f"[noise {level}] PCK@20 "
              f"{result.test_metrics['pck@0.2'] * 100:.2f}% "
              f"MPJPE {result.test_metrics['mpe']:.4f}")
        print("[timings] " + json.dumps(result.timings))

    if not mesh.is_main():
        return 0
    out_path = os.path.join(args.output_dir,
                            f"robustness_{args.model}_mode{args.mode}.json")
    with open(out_path, "w", encoding="utf-8") as fd:
        json.dump(results, fd, indent=2)
    print(f"[done] results -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
