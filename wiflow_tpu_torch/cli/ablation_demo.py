"""Ablation table: the model's switches, trained on the same data.

Counterpart of ``wiflow_tpu/cli/ablation_demo.py``.  The reference
publishes a Setting-1 ablation table (ref README.md:240-248: the full
model, a plain conv1d TCN, a 2-D residual conv encoder, depthwise convs,
no axial attention) and ships no ablation code.  The variants are
``ModelConfig`` switches (``tcn_conv``, ``encoder_kind``,
``use_attention``); this CLI trains each on the same synthetic windows
(``cli/convergence_demo.py::synth_windows``, made on the device) with the
same recipe, and writes ``ablation_summary.json`` and ``ablation_table.md``
after every variant.  Each variant trains in ``--output_dir/<variant>``
and resumes there from ``latest_checkpoint.pkl``.  Flag for flag the JAX
CLI's, with the same defaults, plus ``--device``: ``cuda`` (the default;
it raises where there is no card) or ``cpu``.  Beside the JAX rows' keys a
row has ``epoch_s`` and ``step_ms``, the mean train epoch and step time
(host clock, CUDA-synchronised at each epoch's end).

Usage:
  python -m wiflow_tpu_torch.cli.ablation_demo --windows 60000 \\
      --epochs 10 --output_dir measured/ablations
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


from wiflow_tpu_torch.cli.convergence_demo import synth_windows
from wiflow_tpu_torch.cli.run import set_seed
from wiflow_tpu_torch.core.config import (
    Config, MeshConfig, ModelConfig, OptimConfig, TrainConfig,
    resolve_device,
)
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.train.loop import train_pose_model

VARIANTS = (
    # (name, ref README.md row, ModelConfig overrides)
    ("full", "WiFlow (full), :244", {}),
    ("tcn_plain", "TCN -> regular 1-D conv, :245", {"tcn_conv": "plain"}),
    ("conv2d_encoder", "TCN + asym conv -> 2D res conv, :246",
     {"encoder_kind": "conv2d"}),
    ("group_depthwise", "group conv -> depthwise conv, :247",
     {"tcn_conv": "depthwise"}),
    ("no_attention", "- axial attention, :248", {"use_attention": False}),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ablation measured run "
                                            "(PyTorch/CUDA)")
    p.add_argument("--windows", type=int, default=60_000)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--output_dir", type=str, default="measured/ablations")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--variants", type=str,
                   default=",".join(v[0] for v in VARIANTS),
                   help="comma-separated subset to run")
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--depthwise_lr", type=float, default=None,
                   help="lr of group_depthwise (depthwise-separable TCNs "
                        "want a larger step than the grouped recipe's 1e-4)")
    p.add_argument("--synth_mode", choices=["linear", "multipath"],
                   default="multipath",
                   help="synthetic CSI observation model (see "
                        "convergence_demo.synth_windows): 'multipath' "
                        "encodes the pose in wrapped path delays and "
                        "Doppler amplitudes, 'linear' is invertible frame "
                        "by frame")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train: the CUDA card (default) or the CPU")
    return p


def _write_tables(out_dir: str, n: int, epochs: int, rows) -> None:
    with open(os.path.join(out_dir, "ablation_summary.json"), "w",
              encoding="utf-8") as fd:
        json.dump({"windows": n, "epochs": epochs, "rows": rows,
                   "reference_table": "README.md:240-248"}, fd, indent=2)
    md = ["| Variant | PCK@10 | PCK@20 | MPJPE (m) | Params |",
          "|---|---|---|---|---|"]
    for r in rows:
        md.append(f"| {r['variant']} | {r['pck10']} | {r['pck20']} | "
                  f"{r['mpjpe_m']} | {r['params'] / 1e6:.2f}M |")
    with open(os.path.join(out_dir, "ablation_table.md"), "w",
              encoding="utf-8") as fd:
        fd.write("\n".join(md) + "\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_seed(args.seed)
    dev = resolve_device(args.device)
    wanted = set(args.variants.split(","))
    unknown = wanted - {v[0] for v in VARIANTS}
    if unknown:
        raise SystemExit(f"--variants: unknown {sorted(unknown)}; choose "
                         f"from {[v[0] for v in VARIANTS]}")

    os.makedirs(args.output_dir, exist_ok=True)
    n = args.windows
    n_tr, n_va = int(n * 0.7), int(n * 0.15)
    t0 = time.time()
    train = synth_windows(n_tr, args.seed, mode=args.synth_mode, device=dev)
    val = synth_windows(n_va, args.seed + 101, mode=args.synth_mode,
                        device=dev)
    test = synth_windows(n - n_tr - n_va, args.seed + 202,
                         mode=args.synth_mode, device=dev)
    print(f"[data] {n} windows (train {n_tr} / val {n_va} / "
          f"test {n - n_tr - n_va}), synth_mode={args.synth_mode}, made on "
          f"{dev} in {time.time() - t0:.2f}s")

    rows = []
    data_dtype = ("bfloat16" if args.compute_dtype == "bfloat16"
                  else "float32")
    for name, ref_row, overrides in VARIANTS:
        if name not in wanted:
            continue
        run_dir = os.path.join(args.output_dir, name)
        model_cfg = ModelConfig(compute_dtype=args.compute_dtype, **overrides)
        lr = args.lr
        if name == "group_depthwise" and args.depthwise_lr:
            lr = args.depthwise_lr
        cfg = Config(
            model=model_cfg,
            train=TrainConfig(batch_size=args.batch_size,
                              num_epochs=args.epochs, patience=10 ** 6,
                              seed=args.seed, data_dtype=data_dtype,
                              optim=OptimConfig(lr=lr, weight_decay=5e-5)),
            mesh=MeshConfig(num_devices=1), output_dir=run_dir)
        t0 = time.time()
        result = train_pose_model(train, val, test, cfg, run_dir,
                                  resume=True, device=dev)
        wall = time.time() - t0
        params = sum(p.numel() for p in
                     WiFlowPoseModel(model_cfg, device="cpu").parameters())
        steps = max(1, n_tr // min(args.batch_size, n_tr))
        tr_s = result.timings["train_s"]
        tm = result.test_metrics
        row = {
            "variant": name,
            "reference_row": ref_row,
            "lr": lr,
            "pck10": round(float(tm["pck@0.1"]) * 100, 2),
            "pck20": round(float(tm["pck@0.2"]) * 100, 2),
            "mpjpe_m": round(float(tm["mpe"]), 4),
            "params": int(params),
            "wall_clock_min": round(wall / 60, 2),
            "epoch_s": (sum(result.timings["epoch_s"]) / len(tr_s)
                        if tr_s else None),
            "step_ms": (1e3 * sum(tr_s) / len(tr_s) / steps
                        if tr_s else None),
        }
        rows.append(row)
        print(f"[{name}] PCK@10 {row['pck10']}% PCK@20 {row['pck20']}% "
              f"MPJPE {row['mpjpe_m']} m, {params / 1e6:.2f}M params "
              f"({row['wall_clock_min']} min; step {row['step_ms']} ms)")
        # after every variant: a run stopped part-way leaves a valid table
        _write_tables(args.output_dir, n, args.epochs, rows)
    print(f"[done] summary -> {args.output_dir}/ablation_summary.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
