"""Reference-scale convergence run on synthetic CSI made on the device.

Counterpart of ``wiflow_tpu/cli/convergence_demo.py``: ``synth_windows``
(the windows that ``cli/ablation_demo.py``, ``cli/baseline_table.py`` and
``cli/loso_demo.py`` train on too) and ``main``, flag for flag with the
JAX CLI's defaults plus ``--device`` (``cuda``, the default, or ``cpu``):
70/15/15 splits drawn each into its own buffer (seeds ``+0/+101/+202``),
trained in bf16 storage on one device, then the artifacts of
``eval/artifacts.py`` (the videos skipped, with a printed line, where
OpenCV is missing) and ``run_summary.json``.  ``--resume`` continues from
``latest_checkpoint.pkl`` in ``--output_dir`` (``cli/kill_resume_demo.py``
reads the ``[data]``, ``Epoch k/``, ``[resume]``, ``[early-stop]`` and
``[done]`` lines).

Usage:
  python -m wiflow_tpu_torch.cli.convergence_demo --windows 360000 \
      --epochs 50 --output_dir measured/convergence

The generative structure is the JAX function's: per-window smooth pose
trajectories (sums of random sinusoids), then a CSI observation model:

* ``"linear"``: one global linear map of [pose, velocity] into subcarrier
  space, plus noise.  Invertible frame by frame, so it cannot reward
  temporal or cross-subcarrier modelling.
* ``"multipath"``: motion-modulated multipath.  Each of P scatter paths
  has a pose-dependent delay ``tau_p(t) = w_p . kp(t)``; subcarrier c sees
  ``sum_p A_p(t) cos(omega_c tau_p(t) + phi_p)`` with a Doppler-style
  amplitude ``A_p(t) = a_p (1 + tanh(u_p . 8 vel(t)))``: a wrapped,
  many-to-one view of the pose per subcarrier.

The radio world (the mixing map, the paths, the phases) depends on
``mix_seed`` only, so it is the same across splits and subjects; the
trajectories are drawn from ``seed``.  Everything is drawn on the device
from ``torch.Generator``s there, a chunk at a time, into preallocated bf16
buffers; ``multipath`` adds its paths one at a time, never holding a
``[m, T, P, C]`` intermediate.  :func:`observe` is the observation model
as a function of the draws, so that a test can feed it the JAX package's.
The torch generators draw other numbers than ``jax.random``: the port's
windows have the JAX windows' distribution, not their values.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Tuple

import torch

from wiflow_tpu_torch.core.config import (
    Config, MeshConfig, OptimConfig, TrainConfig, resolve_device,
)
from wiflow_tpu_torch.eval.artifacts import write_all_artifacts
from wiflow_tpu_torch.train.loop import train_pose_model


@dataclasses.dataclass(frozen=True)
class SynthWorld:
    """The radio world that every split and subject shares."""

    mix: torch.Tensor        # [2 * 2K, C]: [pose, velocity] -> CSI
    w_path: torch.Tensor     # [2K, P]: path delays from the pose
    u_path: torch.Tensor     # [2K, P]: Doppler from the velocity
    a_path: torch.Tensor     # [P] path amplitudes
    phi: torch.Tensor        # [P, C] path phases
    omega: torch.Tensor      # [C] wavenumbers, 4 .. 16


def synth_world(num_subcarriers: int = 540, keypoints: int = 15,
                mix_seed: int = 7, n_paths: int = 48,
                device=None) -> SynthWorld:
    """The world of ``mix_seed``, drawn on ``device`` (CUDA unless
    ``"cpu"``) with the JAX function's distributions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(mix_seed)
    k2, c, p = 2 * keypoints, num_subcarriers, n_paths

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    return SynthWorld(
        mix=normal(2 * k2, c), w_path=normal(k2, p) / math.sqrt(k2),
        u_path=normal(k2, p) / math.sqrt(k2), a_path=0.7 + 0.6 * uniform(p),
        phi=2 * math.pi * uniform(p, c),
        omega=torch.linspace(4.0, 16.0, c, device=dev))


def subject_style(subject: int) -> Tuple[float, float, float, float]:
    """``(amp_scale, freq_lo, freq_hi, csi_gain)`` of ``subject`` (1..5; 0
    is generic): each subject moves with its own amplitude and frequency
    range and is seen with its own CSI gain."""
    s = subject
    amp_scale = 0.08 * (1.0 + 0.25 * ((s % 3) - 1)) if s else 0.08
    freq_lo = 0.05 + (0.03 * (s - 1) if s else 0.0)
    freq_hi = 0.4 + (0.06 * ((s % 2) * 2 - 1) if s else 0.0)
    csi_gain = 1.0 + (0.06 * (s - 3) if s else 0.0)
    return amp_scale, freq_lo, freq_hi, csi_gain


def observe(world: SynthWorld, base: torch.Tensor, amp: torch.Tensor,
            freq: torch.Tensor, phase: torch.Tensor, noise: torch.Tensor, *,
            mode: str, csi_gain: float, keypoints: int = 15
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The windows of one chunk from its draws: ``base``, ``amp``,
    ``freq``, ``phase`` ``[m, 1, 2K]`` (already scaled: the pose offset,
    the amplitude, the frequency and the phase of each coordinate's
    sinusoid) and ``noise [m, T, C]`` (standard normal).  Returns ``x
    [m, C, T]`` in bf16 and the last frame's pose ``y [m, K, 2]`` + 0.5 in
    fp32."""
    if mode not in ("linear", "multipath"):
        raise ValueError(f"mode={mode!r}: 'linear' or 'multipath'")
    m, window = noise.shape[0], noise.shape[1]
    t = torch.arange(window, dtype=torch.float32,
                     device=noise.device)[None, :, None]
    kp = base + amp * torch.sin(freq * t + phase)            # [m, T, 2K]
    vel = torch.diff(kp, dim=1, prepend=kp[:, :1])
    if mode == "multipath":
        csi = 0.05 * noise + 1.0
        tau = kp @ world.w_path                              # [m, T, P]
        gain = world.a_path * (1.0 + torch.tanh((8.0 * vel) @ world.u_path))
        # the P=8 recipes' CSI spread, kept at any P
        scale = csi_gain / (world.a_path.numel() / 8.0) ** 0.5
        for p in range(world.a_path.numel()):
            ang = tau[..., p, None] * world.omega + world.phi[p]
            csi += scale * gain[..., p, None] * torch.cos(ang)
    else:
        feats = torch.cat([kp, 5.0 * vel], dim=-1)           # [m, T, 4K]
        csi = csi_gain * (feats @ world.mix) + 0.05 * noise + 1.0
    x = csi.transpose(1, 2).to(torch.bfloat16)
    y = kp[:, -1, :].reshape(m, keypoints, 2) + 0.5
    return x, y


def synth_windows(n: int, seed: int, num_subcarriers: int = 540,
                  window: int = 20, keypoints: int = 15,
                  chunk: int = 15_000, mix_seed: int = 7,
                  subject: int = 0, mode: str = "linear",
                  n_paths: int = 48, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` CSI windows ``x [n, 540, 20]`` (bf16) and their last-frame
    poses ``y [n, 15, 2]`` (fp32), on ``device`` (CUDA unless ``"cpu"``),
    drawn ``chunk`` windows at a time from a generator seeded with
    ``seed + 1``; the world from ``mix_seed`` (:func:`synth_world`).
    ``n_paths`` must be at least ``2 * keypoints`` for the pose to be
    recoverable from ``"multipath"`` CSI at all."""
    dev = resolve_device(device)
    world = synth_world(num_subcarriers, keypoints, mix_seed, n_paths, dev)
    amp_scale, freq_lo, freq_hi, csi_gain = subject_style(subject)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    k2 = 2 * keypoints
    xbuf = torch.empty(n, num_subcarriers, window, dtype=torch.bfloat16,
                       device=dev)
    ybuf = torch.empty(n, keypoints, 2, dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)

        def draw(*shape, uniform=False):
            f = torch.rand if uniform else torch.randn
            return f(shape, generator=gen, device=dev)

        base = 0.2 * draw(m, 1, k2)
        amp = amp_scale * draw(m, 1, k2)
        freq = freq_lo + (freq_hi - freq_lo) * draw(m, 1, k2, uniform=True)
        phase = 2 * math.pi * draw(m, 1, k2, uniform=True)
        noise = draw(m, window, num_subcarriers)
        xbuf[lo:lo + m], ybuf[lo:lo + m] = observe(
            world, base, amp, freq, phase, noise, mode=mode,
            csi_gain=csi_gain, keypoints=keypoints)
    return xbuf, ybuf


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="reference-scale convergence run")
    p.add_argument("--windows", type=int, default=360_000)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)       # train.py:105
    p.add_argument("--output_dir", type=str,
                   default="measured/convergence")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_videos", action="store_true")
    p.add_argument("--use_augmentation", action="store_true",
                   help="train.py:187-193 on-device augmentation policy")
    p.add_argument("--patience", type=int, default=5)   # train.py:382
    p.add_argument("--resume", action="store_true",
                   help="continue from latest_checkpoint.pkl in "
                        "--output_dir (kill/resume demos)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train: the CUDA card (default) or the CPU")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    t0 = time.time()
    n = args.windows
    n_tr, n_va = int(n * 0.7), int(n * 0.15)
    # a buffer a split, on the device: no host copy, no second buffer
    train = synth_windows(n_tr, args.seed, device=dev)
    val = synth_windows(n_va, args.seed + 101, device=dev)
    test = synth_windows(n - n_tr - n_va, args.seed + 202, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gen_sec = time.time() - t0
    print(f"[data] {n} windows generated on-device in {gen_sec:.1f}s "
          f"(train {n_tr} / val {n_va} / test {n - n_tr - n_va})")

    cfg = Config(
        train=TrainConfig(batch_size=args.batch_size, num_epochs=args.epochs,
                          patience=args.patience, seed=args.seed,
                          use_augmentation=args.use_augmentation,
                          data_dtype="bfloat16",
                          optim=OptimConfig(lr=args.lr, weight_decay=5e-5)),
        mesh=MeshConfig(num_devices=1), output_dir=args.output_dir)

    t1 = time.time()
    result = train_pose_model(train, val, test, cfg, args.output_dir,
                              resume=args.resume, device=dev)
    train_sec = time.time() - t1
    paths = write_all_artifacts(result, args.output_dir,
                                make_videos=not args.no_videos)

    summary = {
        "windows": n,
        "epochs_requested": args.epochs,
        "epochs_run": result.epochs_run,
        "best_epoch": result.best_epoch + 1,
        "early_stopped": result.epochs_run < args.epochs,
        "train_wall_clock_sec": round(train_sec, 1),
        "data_gen_sec": round(gen_sec, 1),
        "test_metrics": {k: round(float(v), 6)
                         for k, v in result.test_metrics.items()},
        "final_lr": float(result.history["lr"][-1]),
        "lr_reductions": sorted({float(v) for v in result.history["lr"]},
                                reverse=True),
        "val_mpe_trajectory": [round(float(v), 5)
                               for v in result.history["val_mpe"]],
        "val_pck20_trajectory": [round(float(v), 5)
                                 for v in result.history["val_pck"]],
        "artifacts": sorted(os.path.basename(p) for p in paths.values()),
    }
    out = os.path.join(args.output_dir, "run_summary.json")
    with open(out, "w", encoding="utf-8") as fd:
        json.dump(summary, fd, indent=2)
    print(f"[done] {result.epochs_run} epochs in {train_sec / 60:.1f} min "
          f"| test PCK@20 {result.test_metrics['pck@0.2'] * 100:.2f}% "
          f"MPJPE {result.test_metrics['mpe']:.4f} m | summary -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
