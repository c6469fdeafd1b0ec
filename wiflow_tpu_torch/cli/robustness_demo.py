"""CLI entry point: the HPE-Li noise-robustness sweep under three defences.

Counterpart of ``wiflow_tpu/cli/robustness_demo.py``, plus ``--device``
(``cuda``, the default, or ``cpu``), passed on to ``run_robustness``.
Mirrors the experiment matrix of ref /root/reference/cross_dataset_test/
HPE-Li/main.py:52-105 — for each AWGN noise level, measure the trained
pose model under the three defenses:

  none      mode-0 model (trained clean) evaluated on noisy CSI,
  filter    mode-2 pipeline (corrupt + traditional filter, then train
            and test on the filtered data),
  denoiser  mode-1 pipeline (greedy stacked-AE pre-training at the
            level, then DenoiserHPE trained end-to-end, evaluated on
            noisy CSI).

Runs on the learnable synthetic MM-Fi miniature (data/mmfi.py
``generate_synthetic_mmfi(learnable=True)``) so the models genuinely
learn the CSI->pose mapping and the sweep has dynamic range.  One
documented deviation from the reference recipe: the optimizer is Adam
(the reference's plain SGD lr=1e-3, main.py:67, needs the full 300k-frame
MM-Fi + 60 epochs to converge; on the miniature it stays near the mean
pose and flattens the sweep).  Everything else — conf-weighted MSE/32,
linear decay from epoch 20, PCK-max checkpointing — is the reference
recipe via run_robustness.  ``--collate_only`` rebuilds ``summary.json``
and ``summary.md`` from the ``*_results.json`` already in ``--output_dir``.
The work tree and the synthetic MM-Fi tree default to the temporary
directory (``TMPDIR``), as the JAX demo's ``/tmp`` defaults.

Usage:
  python -m wiflow_tpu_torch.cli.robustness_demo --output_dir robustness_demo
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HPE-Li robustness sweep demo")
    tmp = tempfile.gettempdir()
    p.add_argument("--output_dir", type=str, default="robustness_demo")
    p.add_argument("--work_dir", type=str,
                   default=os.path.join(tmp, "robustness_work"))
    p.add_argument("--dataset_root", type=str,
                   default=os.path.join(tmp, "mmfi_robustness"))
    p.add_argument("--levels", type=float, nargs="+", default=[0.1, 0.3])
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--model", type=str, default="original_hpe")
    p.add_argument("--filter", choices=("gaussian", "mean"),
                   default="gaussian")
    p.add_argument("--denoiser_stages", type=int, default=5)
    p.add_argument("--denoiser_epochs", type=int, default=5)
    p.add_argument("--synthetic_frames", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--collate_only", action="store_true",
                   help="rebuild summary.{json,md} from the "
                        "*_results.json already in --output_dir")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train: the CUDA card (default) or the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from wiflow_tpu_torch.cli import run_robustness

    levels = [str(l) for l in args.levels]
    common = ["--epochs", str(args.epochs), "--optimizer", "adam",
              "--seed", str(args.seed),
              "--synthetic", "--synthetic_learnable",
              "--synthetic_frames", str(args.synthetic_frames),
              "--dataset_root", args.dataset_root,
              "--noise_levels", *levels, "--no_resume", "--device",
              args.device]
    os.makedirs(args.output_dir, exist_ok=True)

    plans = [
        ("none", ["--model", args.model, "--mode", "0"]),
        ("filter", ["--model", args.model, "--mode", "2",
                    "--filter", args.filter]),
        ("denoiser", ["--model", "denoiser_hpe", "--mode", "1",
                      "--denoiser_stages", str(args.denoiser_stages),
                      "--denoiser_epochs", str(args.denoiser_epochs)]),
    ]
    raw = {}
    for name, extra in plans:
        if args.collate_only:
            with open(os.path.join(args.output_dir,
                                   f"{name}_results.json"), "r",
                      encoding="utf-8") as fd:
                raw[name] = json.load(fd)
            continue
        out = os.path.join(args.work_dir, name)
        print(f"=== [{name}] ===", flush=True)
        rc = run_robustness.main(extra + common + ["--output_dir", out])
        if rc != 0:
            print(f"[robustness_demo] {name} failed rc={rc}")
            return rc
        (path,) = glob.glob(os.path.join(out, "robustness_*.json"))
        with open(path, "r", encoding="utf-8") as fd:
            raw[name] = json.load(fd)
        shutil.copy(path, os.path.join(args.output_dir,
                                       f"{name}_results.json"))
        for hist in glob.glob(os.path.join(out, "*", "training_history.csv")):
            run = os.path.basename(os.path.dirname(hist))
            shutil.copy(hist, os.path.join(args.output_dir,
                                           f"history_{name}_{run}.csv"))

    # ---- collate the PCK-vs-noise table --------------------------------
    def entry(block, key):
        row = block["sweep"].get(key)
        return {"pck20": row["pck@0.2"] * 100, "pck50": row["pck@0.5"] * 100,
                "mpjpe": row["mpjpe"]} if row else None

    def test_entry(block):
        return {"pck20": block["test_pck20"] * 100,
                "pck50": block["test_pck50"] * 100,
                "mpjpe": block["test_mpjpe"]}

    any_level = levels[0]
    table = {"clean": entry(raw["none"][any_level], "0.0"), "levels": {}}
    for lv in levels:
        # modes 1/2's headline is their test metrics: the test split was
        # corrupted at `lv` and passed through the defense (traditional
        # filter / trained denoiser) before eval — the post-train sweep
        # entries would corrupt a second time on top.
        table["levels"][lv] = {
            "none": entry(raw["none"][lv], lv),
            "filter": test_entry(raw["filter"][lv]),
            "denoiser": test_entry(raw["denoiser"][lv]),
        }

    summary = {"config": vars(args), "table": table}
    with open(os.path.join(args.output_dir, "summary.json"), "w",
              encoding="utf-8") as fd:
        json.dump(summary, fd, indent=2)

    lines = ["# HPE-Li robustness sweep (measured)", "",
             f"Model: {args.model} (+ DenoiserHPE for mode 1), "
             f"{args.epochs} epochs, Adam (see module docstring), "
             f"AWGN, filter={args.filter}.", "",
             "| noise σ | defense | PCK@20 % | PCK@50 % | MPJPE |",
             "|---|---|---|---|---|",
             f"| 0.0 | – (clean) | {table['clean']['pck20']:.2f} | "
             f"{table['clean']['pck50']:.2f} | "
             f"{table['clean']['mpjpe']:.4f} |"]
    for lv, rows in table["levels"].items():
        for defense in ("none", "filter", "denoiser"):
            r = rows[defense]
            lines.append(f"| {lv} | {defense} | {r['pck20']:.2f} | "
                         f"{r['pck50']:.2f} | {r['mpjpe']:.4f} |")
    md = "\n".join(lines) + "\n"
    with open(os.path.join(args.output_dir, "summary.md"), "w",
              encoding="utf-8") as fd:
        fd.write(md)
    print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
