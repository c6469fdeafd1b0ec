"""Mid-run kill/resume demonstration.

Counterpart of ``wiflow_tpu/cli/kill_resume_demo.py``, flag for flag with
its defaults plus ``--device`` (``cuda``, the default, or ``cpu``, passed
on to the runs).  It runs the convergence demo
(``python -u -m wiflow_tpu_torch.cli.convergence_demo``) three ways:

  A. uninterrupted,
  B. SIGKILLed mid-epoch ``--kill_epoch + 1``, then relaunched with
     ``--resume``: it must continue from ``latest_checkpoint.pkl`` at
     epoch ``--kill_epoch + 1`` (asserted on its ``[resume]`` line), and
     the combined history must match run A epoch for epoch (the trainer
     seeds each epoch's generators from ``(seed, epoch)``, so a resumed
     run repeats the uninterrupted one),
  C. (optional, ``--early_stop_demo``) a small-data run with patience 3,
     where early stopping fires.

The trainer prints ``Epoch K/`` before it writes epoch K's bundle, so run
B1 is killed once the bundle holds epoch K (the line seen, the bundle
read back each time its file changes): epoch K+1 is then under way and
has no bundle.  Each history column is compared at ``max(2e-4, 2e-3 |a|)``
as in the JAX demo, and its largest difference is reported.  Writes
``kill_resume_summary.json``.

Usage:
  python -m wiflow_tpu_torch.cli.kill_resume_demo --windows 360000 \\
      --epochs 50 --kill_epoch 20 --output_dir measured/kill_resume
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import signal
import subprocess
import sys
import time

from wiflow_tpu_torch.core.checkpoint import load_checkpoint

COMPARED = ("train_loss", "val_loss", "val_mpe", "lr")
# the directory that holds the package, for the runs' imports
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _wait_for_bundle(output_dir, epoch, proc, timeout=3600.0):
    """Until ``latest_checkpoint.pkl`` in ``output_dir`` holds ``epoch``
    (1-based) or a later one, or ``proc`` has ended; the bundle is read
    again only when its file changes (it is replaced whole)."""
    path = os.path.join(output_dir, "latest_checkpoint.pkl")
    seen, t0 = None, time.time()
    while proc.poll() is None and time.time() - t0 < timeout:
        try:
            stamp = os.stat(path).st_mtime_ns
        except FileNotFoundError:
            stamp = None
        if stamp is not None and stamp != seen:
            seen = stamp
            ckpt = load_checkpoint(path)
            if ckpt is not None and ckpt["epoch"] + 1 >= epoch:
                return
        time.sleep(0.01)


def run_demo(args_list, output_dir, kill_on_epoch=None, device="cuda"):
    """Run convergence_demo as a subprocess; optionally SIGKILL it once
    'Epoch {kill_on_epoch}/' has appeared and that epoch's bundle is
    written, while the next epoch is running.  Returns (returncode,
    killed, lines)."""
    cmd = [sys.executable, "-u", "-m",
           "wiflow_tpu_torch.cli.convergence_demo", "--output_dir",
           output_dir, "--no_videos", "--device", device] + args_list
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    killed = False
    lines = []
    for line in proc.stdout:
        lines.append(line.rstrip())
        if (len(lines) % 5 == 0 or "Epoch" in line
                or "[resume]" in line or "[early-stop]" in line):
            print(f"  | {line.rstrip()}", flush=True)
        if (kill_on_epoch is not None and not killed
                and line.startswith(f"Epoch {kill_on_epoch}/")):
            _wait_for_bundle(output_dir, kill_on_epoch, proc)
            proc.send_signal(signal.SIGKILL)
            killed = True
            print(f"  [kill] SIGKILL after epoch {kill_on_epoch}'s bundle",
                  flush=True)
    proc.wait()
    return proc.returncode, killed, lines


def read_history(output_dir):
    path = os.path.join(output_dir, "training_history.csv")
    with open(path, newline="", encoding="utf-8") as fd:
        return list(csv.DictReader(fd))


def history_compare(hist_a, hist_b):
    """Epoch by epoch over ``COMPARED``: the mismatches at
    ``max(2e-4, 2e-3 |a|)`` and the largest difference."""
    mismatches, max_abs = [], 0.0
    n = min(len(hist_a), len(hist_b))
    for i in range(n):
        for k in COMPARED:
            a, b = float(hist_a[i][k]), float(hist_b[i][k])
            max_abs = max(max_abs, abs(a - b))
            if abs(a - b) > max(2e-4, 2e-3 * abs(a)):
                mismatches.append({"epoch": i + 1, "key": k, "a": a, "b": b})
    return {"epochs_compared": n, "mismatches": mismatches[:10],
            "identical_within_tol": not mismatches, "max_abs_diff": max_abs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="kill/resume measured demo")
    p.add_argument("--windows", type=int, default=360_000)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--kill_epoch", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--output_dir", type=str, default="measured/kill_resume")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--skip_uninterrupted", action="store_true",
                   help="reuse an existing run A (pass --ref_history)")
    p.add_argument("--ref_history", type=str, default=None,
                   help="training_history.csv of an uninterrupted run to "
                        "compare against instead of running A")
    p.add_argument("--early_stop_demo", action="store_true",
                   help="also run a small-data aggressive-patience run "
                        "where early stopping fires")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the runs train: the CUDA card (default) or "
                        "the CPU")
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    base = ["--windows", str(args.windows), "--epochs", str(args.epochs),
            "--batch_size", str(args.batch_size), "--seed", str(args.seed)]
    summary = {"windows": args.windows, "epochs": args.epochs,
               "kill_epoch": args.kill_epoch}

    dir_a = os.path.join(args.output_dir, "uninterrupted")
    if args.ref_history:
        with open(args.ref_history, newline="", encoding="utf-8") as fd:
            hist_a = list(csv.DictReader(fd))
        summary["run_a"] = {"reused": args.ref_history}
    elif not args.skip_uninterrupted:
        print("[A] uninterrupted run")
        t0 = time.time()
        rc, _, _ = run_demo(base, dir_a, device=args.device)
        assert rc == 0, f"run A failed rc={rc}"
        hist_a = read_history(dir_a)
        summary["run_a"] = {"wall_min": round((time.time() - t0) / 60, 1),
                            "epochs": len(hist_a)}
    else:
        hist_a = read_history(dir_a)
        summary["run_a"] = {"reused": dir_a}

    dir_b = os.path.join(args.output_dir, "killed")
    print(f"[B1] run to be SIGKILLed mid-epoch {args.kill_epoch + 1}")
    t0 = time.time()
    rc1, killed, _ = run_demo(base, dir_b, kill_on_epoch=args.kill_epoch,
                              device=args.device)
    assert killed and rc1 != 0, f"expected a killed run, rc={rc1}"
    print("[B2] resume from latest_checkpoint.pkl")
    rc2, _, lines2 = run_demo(base + ["--resume"], dir_b, device=args.device)
    assert rc2 == 0, f"resume failed rc={rc2}"
    resume_line = next((ln for ln in lines2 if "[resume]" in ln), None)
    assert resume_line is not None, "no [resume] line in run B2"
    expected = f"continuing from epoch {args.kill_epoch + 1} "
    assert expected in resume_line, (
        f"run B2 resumed elsewhere than mid-epoch {args.kill_epoch + 1}: "
        f"{resume_line!r}")
    hist_b = read_history(dir_b)
    summary["run_b"] = {
        "killed_mid_epoch": args.kill_epoch + 1,
        "resume_line": resume_line.strip(),
        "wall_min_total": round((time.time() - t0) / 60, 1),
        "epochs": len(hist_b),
    }

    # the resumed trajectory must equal the uninterrupted one
    summary["history_compare"] = history_compare(hist_a, hist_b)
    cmp_ = summary["history_compare"]
    print(f"[compare] {cmp_['epochs_compared']} epochs, mismatches: "
          f"{len(cmp_['mismatches'])}, max |a - b| {cmp_['max_abs_diff']:.3g}")

    if args.early_stop_demo:
        dir_c = os.path.join(args.output_dir, "early_stop")
        print("[C] early-stop demo (small data, patience 3)")
        rc, _, lines3 = run_demo(
            ["--windows", "40000", "--epochs", "80", "--patience", "3",
             "--batch_size", str(args.batch_size),
             "--seed", str(args.seed)], dir_c, device=args.device)
        assert rc == 0
        with open(os.path.join(dir_c, "run_summary.json"),
                  encoding="utf-8") as fd:
            c_sum = json.load(fd)
        es_line = next((ln for ln in lines3 if "[early-stop]" in ln), None)
        summary["early_stop_demo"] = {
            "early_stopped": c_sum["early_stopped"],
            "epochs_run": c_sum["epochs_run"],
            "best_epoch": c_sum["best_epoch"],
            "early_stop_line": (es_line or "").strip(),
        }
        print(f"  early_stopped={c_sum['early_stopped']} after "
              f"{c_sum['epochs_run']} epochs")

    out = os.path.join(args.output_dir, "kill_resume_summary.json")
    with open(out, "w", encoding="utf-8") as fd:
        json.dump(summary, fd, indent=2)
    print(f"[done] summary -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
