"""Trained five-model comparison table: WiFlow against the four baselines.

Counterpart of ``wiflow_tpu/cli/baseline_table.py``.  The reference's
headline result is a Setting-1 comparison of WiFlow with WPformer, WiSPPN,
PerUnet and HPE-Li (ref README.md:109-120: PCK@20-50, MPJPE, parameters,
FLOPs, train time), made by five separate scripts.  This CLI trains all
five through the one engine on the same synthetic windows
(``cli/convergence_demo.py::synth_windows``, made on the device) and
writes ``comparison_summary.json`` and ``comparison_table.md`` after every
model, keeping the rows of earlier runs for models it does not rerun.

The PAM-labelled models (WPformer, WiSPPN, PerUnet) train on PAMs made
from the keypoints (diagonal = coordinates, unit confidence).
WiSPPN/PerUnet predict whole PAMs and are scored on the keypoints of their
predicted diagonals (ref baseline/WiSPPN/wisppn.py:396-418); WPformer
predicts keypoints and trains on the label's diagonal (ref
baseline/WPformer/model.py:968-974).

Flag for flag the JAX CLI's, with the same defaults, plus ``--device``:
``cuda`` (the default; it raises where there is no card) or ``cpu``.
``--max_steps_per_call`` bounds a TPU matter (the steps of one compiled
epoch scan) and is accepted at its default, 0, only.  Every row has a
FLOPs cell: ``utils/flops.py::flop_count`` of one window, with a
``flops_note`` saying by how much the JAX package's jaxpr count differs
where the model resizes.  Beside the JAX rows' keys a row has
``step_ms``, ``windows_per_s`` (train windows over the train epochs'
host-clock time) and ``peak_mem_gb`` (``torch.cuda.max_memory_allocated``
over the model's run; None on the CPU).

Usage:
  python -m wiflow_tpu_torch.cli.baseline_table --windows 20000 \\
      --epochs 8 --output_dir measured/baselines
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from wiflow_tpu_torch.cli.convergence_demo import synth_windows
from wiflow_tpu_torch.cli.run import set_seed
from wiflow_tpu_torch.cli.run_baseline import (
    BASELINE_SPECS, build_model, optim_config,
)
from wiflow_tpu_torch.core.config import (
    Config, MeshConfig, ModelConfig, OptimConfig, TrainConfig, exact_fp32,
    resolve_device,
)
from wiflow_tpu_torch.data.pam import pam_train_kwargs
from wiflow_tpu_torch.models.baselines.wisppn import keypoints_to_pam
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.train.loop import train_pose_model
from wiflow_tpu_torch.utils.flops import (
    count_params, flop_count, resize_flops,
)

MODELS = ("wiflow", "hpeli", "wisppn", "perunet", "wpformer")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="baseline comparison table "
                                            "(PyTorch/CUDA)")
    p.add_argument("--windows", type=int, default=20_000)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--output_dir", type=str, default="measured/baselines")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--models", type=str, default=",".join(MODELS),
                   help="comma-separated subset to run")
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--per_model_epochs", type=str, default="",
                   help="name=E,name=E overrides (the reference's rows are "
                        "per recipe too: 2.3 h WiFlow, 68 h WiSPPN)")
    p.add_argument("--per_model_batch", type=str, default="",
                   help="name=B,name=B overrides: WiSPPN and PerUnet "
                        "upsample to 120x120 and 24x24 with 121M and 309M "
                        "parameters")
    p.add_argument("--per_model_lr", type=str, default="",
                   help="name=LR overrides")
    p.add_argument("--per_model_kind", type=str, default="",
                   help="name=adam|sgd|adamw optimizer-family overrides "
                        "(WPformer's SGD recipe assumes an ImageNet warm "
                        "start, which is not in the repository)")
    p.add_argument("--max_steps_per_call", type=int, default=0,
                   help="a TPU matter (steps of one compiled epoch scan); "
                        "only the default, 0, is accepted")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train: the CUDA card (default) or the CPU")
    return p


def _overrides(s: str, cast):
    return {k: cast(v) for k, v in (kv.split("=") for kv in s.split(",")
                                    if kv)}


def _ordered(rows):
    order = {m: i for i, m in enumerate(MODELS)}
    return sorted(rows, key=lambda r: order.get(r["model"], 99))


def _flops(model: torch.nn.Module, x1: torch.Tensor):
    """FLOPs of one window, and the note on the JAX package's count."""
    flops = flop_count(model, x1)
    note = ("torch FlopCounterMode, 2 x MACs of products and convolutions "
            "(the JAX package's jaxpr count)")
    extra = resize_flops(model, x1)
    if extra:
        note += (f"; its bilinear resizes are no products to torch: the JAX "
                 f"count adds {extra / 1e9:.4f} G for them "
                 f"({100 * extra / flops:.2f}%)")
    return flops, note


def _write(out_dir: str, args, device_name: str, rows) -> None:
    with open(os.path.join(out_dir, "comparison_summary.json"), "w",
              encoding="utf-8") as fd:
        json.dump({"windows": args.windows, "epochs": args.epochs,
                   "batch_size": args.batch_size, "device": device_name,
                   "compute_dtype": args.compute_dtype, "rows": rows,
                   "reference_table": "README.md:109-120"}, fd, indent=2)
    md = ["| Model | PCK@20 | PCK@30 | PCK@40 | PCK@50 | MPJPE (m) | "
          "Params (M) | FLOPs (G) | Epochs | Batch | Wall (min) |",
          "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        md.append(f"| {r['model']} | {r['pck20']} | {r['pck30']} | "
                  f"{r['pck40']} | {r['pck50']} | {r['mpjpe_m']} | "
                  f"{r['params_m']} | {r['flops_g']} | "
                  f"{r.get('epochs', args.epochs)} | "
                  f"{r.get('batch_size', args.batch_size)} | "
                  f"{r['wall_clock_min']} |")
    md += ["", f"Shared synthetic dataset ({args.windows} windows); the "
           "structure of the reference Setting-1 table (ref "
           "README.md:109-120), per-model recipes included. Synthetic-data "
           f"scores ({len(rows)} of {len(MODELS)} rows present) show the "
           "train recipes end to end and are NOT comparable to the "
           "reference's real-dataset numbers; the PAM baselines train on "
           "PAMs made from the keypoints."]
    with open(os.path.join(out_dir, "comparison_table.md"), "w",
              encoding="utf-8") as fd:
        fd.write("\n".join(md) + "\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.max_steps_per_call != 0:
        raise SystemExit(f"--max_steps_per_call {args.max_steps_per_call}: "
                         f"a TPU matter (one compiled epoch scan); the port "
                         f"takes its steps one at a time")
    epochs_by = _overrides(args.per_model_epochs, int)
    batch_by = _overrides(args.per_model_batch, int)
    lr_by = _overrides(args.per_model_lr, float)
    kind_by = _overrides(args.per_model_kind, str)
    run_names = args.models.split(",")
    unknown = set(run_names) - set(MODELS)
    if unknown:
        raise SystemExit(f"--models: unknown {sorted(unknown)}; choose from "
                         f"{list(MODELS)}")
    set_seed(args.seed)
    exact_fp32()
    dev = resolve_device(args.device)
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")

    os.makedirs(args.output_dir, exist_ok=True)
    n = args.windows
    n_tr, n_va = int(n * 0.7), int(n * 0.15)
    data_dtype = ("bfloat16" if args.compute_dtype == "bfloat16"
                  else "float32")
    splits = {
        "train": synth_windows(n_tr, args.seed, device=dev),
        "val": synth_windows(n_va, args.seed + 101, device=dev),
        "test": synth_windows(n - n_tr - n_va, args.seed + 202, device=dev),
    }
    print(f"[data] {n} windows (train {n_tr} / val {n_va} / "
          f"test {n - n_tr - n_va}) on {dev}", flush=True)
    # PAM labels once, on the device, shared by the three PAM baselines
    pam_splits = {k: (x, keypoints_to_pam(y)) for k, (x, y) in
                  splits.items()}

    # merge with the rows of earlier runs: a rerun of one model refreshes
    # its row and keeps the others
    summary_path = os.path.join(args.output_dir, "comparison_summary.json")
    rows = []
    if os.path.exists(summary_path):
        with open(summary_path, encoding="utf-8") as fd:
            rows = [r for r in json.load(fd).get("rows", [])
                    if r["model"] not in run_names]
    rows = _ordered(rows)
    x1 = torch.zeros((1, 540, 20), device=dev)

    for name in run_names:
        run_dir = os.path.join(args.output_dir, name)
        n_ep = epochs_by.get(name, args.epochs)
        bsz = batch_by.get(name, args.batch_size)
        kwargs, parts = {}, splits
        if name == "wiflow":
            model = None          # the trainer builds it from cfg.model
            optim = OptimConfig(lr=lr_by.get(name, 1e-4), weight_decay=5e-5)
        else:
            spec = BASELINE_SPECS[name]
            model = build_model(name, args.compute_dtype, device=dev,
                                seed=args.seed)
            optim = optim_config(spec, lr_by.get(name, spec["lr"]), n_ep,
                                 kind_by.get(name))
            if spec["labels"] == "pam":
                parts, kwargs = pam_splits, pam_train_kwargs(spec)
        cfg = Config(
            model=ModelConfig(compute_dtype=args.compute_dtype),
            train=TrainConfig(batch_size=bsz, num_epochs=n_ep,
                              patience=10 ** 6, seed=args.seed,
                              data_dtype=data_dtype, optim=optim),
            mesh=MeshConfig(num_devices=1), output_dir=run_dir)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        result = train_pose_model(parts["train"], parts["val"],
                                  parts["test"], cfg, run_dir, model=model,
                                  resume=True, device=dev, **kwargs)
        wall = time.time() - t0
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else None)
        if model is None:
            model = WiFlowPoseModel(cfg.model, device=dev)
        flops, flops_note = _flops(model, x1)
        print(f"[{name}] flops note: {flops_note}")
        tr_s = result.timings["train_s"]
        steps = max(1, n_tr // min(bsz, n_tr))
        tm = result.test_metrics
        row = {
            "model": name,
            "epochs": n_ep,
            "batch_size": bsz,
            "optim": optim.kind,
            "lr": optim.lr,
            "pck20": round(float(tm["pck@0.2"]) * 100, 2),
            "pck30": round(float(tm["pck@0.3"]) * 100, 2),
            "pck40": round(float(tm["pck@0.4"]) * 100, 2),
            "pck50": round(float(tm["pck@0.5"]) * 100, 2),
            "mpjpe_m": round(float(tm["mpe"]), 4),
            "params_m": round(count_params(model) / 1e6, 2),
            "flops_g": round(flops / 1e9, 3),
            "flops_note": flops_note,
            "wall_clock_min": round(wall / 60, 2),
            "step_ms": 1e3 * sum(tr_s) / (len(tr_s) * steps) if tr_s else None,
            "windows_per_s": (len(tr_s) * steps * bsz / sum(tr_s)
                              if tr_s else None),
            "peak_mem_gb": peak,
        }
        rows = _ordered([r for r in rows if r["model"] != name] + [row])
        print(f"[{name}] PCK@20 {row['pck20']}% MPJPE {row['mpjpe_m']} m "
              f"{row['params_m']}M params {row['flops_g']} GFLOPs "
              f"({row['wall_clock_min']} min; step {row['step_ms']} ms, "
              f"{row['windows_per_s']} windows/s, peak {peak} GiB)",
              flush=True)
        # after every model: a run stopped part-way leaves a valid table
        _write(args.output_dir, args, device_name, rows)
    print(f"[done] table -> {args.output_dir}/comparison_table.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())
