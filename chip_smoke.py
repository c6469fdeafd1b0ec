#!/usr/bin/env python3
"""Drive the port's serving and training paths on one NVIDIA GPU and check
their kernels.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits nonzero; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of the nine CUDA libraries from ``wiflow_tpu_torch/csrc``
   (one nvcc each, started together), with ptxas's registers and spills
   under each kernel's name, and the tensor-core instructions (``HMMA``,
   ``HGMMA``) that ``cuobjdump -sass`` finds in each kernel of
   ``conv_stack``, ``tcn_level``, ``stage_fused``, ``axial_attention``,
   ``axial_attention_dual``, ``axial_attention_v1``, ``axial_core`` and
   ``logits_sums``: ``axial_attention``, ``axial_attention_dual``,
   ``axial_attention_v1`` and ``logits_sums`` must list a bf16 and an fp32
   kernel, the bf16 ones with 126, 252, 0 and 0 ``HMMA`` (one projection on
   the tensor cores, two, none, none), the fp32 ones with none;
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes for batch 4096 (TCN ``[4096, 20, 540]``, conv stack
   ``[81920, 240]``, attention ``[4096, 15, 20, 64]``) and at 7 samples (101
   conv rows), which leave thread blocks part-filled: fp32 with TF32 off,
   and bf16 against the fp32 plain version; then the TCN level and conv
   stack kernels again on N(0, 1) inputs through random weights scaled by
   their fan-in with nonzero biases (the seeded model serves nearly one
   output for every row), each reference checked to vary over rows, and a
   second launch of each held to the first bit for bit; and the three
   attention kernels (v2, the one-launch dual, v1 on each axis's
   precomputed projection) likewise on random folded attention weights,
   at batch 4096 and 7, the dual kernel equal to the v2 kernel bit for
   bit;
3. the slice end to end: the default ``ModelConfig`` (bf16) with seeded
   weights, ``fast_forward`` at batch 4096 (and at batch 7, which leaves
   thread blocks part-filled) against the port's plain-torch module, and
   ``make_stream_infer`` over a ``[4096 + 19, 540]`` stream; every launch
   counter is reset before and read after the batch-4096 run and the
   stream;
4. timings from CUDA events (warm-up, then the median of several runs):
   each kernel, its plain version, the decoder and ``fast_forward``, and
   the TCN levels' pointwise products alone through ``torch.matmul``
   (cuBLAS), a yardstick of the tensor-core rate;
5. the four train kernels (``axial_core`` and ``logits_sums``, forward and
   backward) against their plain versions at the train step's shapes for
   batch 256 (width axis n=3840, L=20; height axis n=5120, L=15), at the
   MM-Fi model's (n=4352, L=10; n=2560, L=17), at the flagship's for
   ``TrainConfig``'s default batch, 64 (n=960, L=20; n=1280, L=15: the
   ``logits_sums`` kernels split a sequence's positions over 2 ranges on
   the first, over 4 at 7 sequences), and at 7 sequences of each
   length, which leave the last tile part-filled: fp32 with TF32 off, the
   ``[2, G]`` sums and ``dscale`` also against float64, and bf16 against
   the fp32 plain version; a second launch of each kernel must repeat the
   first bit for bit, and so must the ``logits_sums`` forward on another
   stream and replayed from a CUDA graph; each shape's
   ``train_attention_plan`` and
   ``sums_plan`` are printed;
6. the training slice: the default ``ModelConfig`` (bf16, dropout
   0.5/0.3), seeded weights, AdamW, batch 256, 2 epochs of 16 steps over
   4096 windows on the card (the launch counters reset before the first
   step and read after it; the second step run with torch's sync debug
   mode set to raise on any host sync); one fp32 step with dropout at 0
   through the kernels against the same step through the plain versions;
   and one ``train_pose_model`` epoch on a 2048/512/512 split;
7. timings: the train step (forward, backward, clip, AdamW) through the
   kernels and through the plain versions, in alternating turns, the
   host's time to enqueue one step, and a ``torch.profiler`` breakdown of
   the step's device time; each train kernel (CUDA events, and the
   device's busy time in it) against its plain version, its bound and
   ``scaled_dot_product_attention``, with ``axial_core``'s launch plan;
   the host's time in one call of each ``logits_sums`` wrapper; peak
   memory;
8. the ``stage`` and ``join`` kernels, forward and backward, against their
   plain versions at the fused train step's shapes for batch 256 (every
   conv geometry, with prologue, mask and bias as the model uses them) and
   at 7 samples, which leave the last thread block part-filled, and
   ``stage`` also at the MM-Fi model's geometries (T = 10, 19/17/16
   channels a group, conv rows of 272 to 17 positions) and on rows of 2,500
   positions, which the launch plan cuts in strips: fp32 with TF32 off,
   the sums and the prologue's gradients also against float64, and bf16
   against the fp32 plain version; a second launch of each must repeat the
   first bit for bit; ``join`` at all 9 joins of the step, at the MM-Fi
   TCN's 342 and 306 channels (2-channel chunks, element masks) and at 17
   channels with a per-sample mask; its backward also on a second stream
   beside the default one, and two shapes that share a workspace back to
   back, each bit-equal to its first launch;
9. the fused training slice: the default ``ModelConfig`` with
   ``tcn_train_impl = conv_train_impl = "fused"``, trained as in phase 6
   (one step must launch ``stage`` 39 times and ``join`` 9 times, forward
   and backward, and each attention kernel twice; in the profiler's order
   of device kernels no ``reduce_affine_grads`` follows a join backward,
   which sums its own partials); one fp32 step with
   dropout on, from one seed, through the fused path against the same step
   through the stock-op path, held to twice the step's fp32 rounding noise
   (measured as stock ops on the card against stock ops on the CPU); one
   ``train_pose_model`` epoch;
10. timings: ``stage`` and ``join`` over the launches of one step and per
   geometry (with the path the launch plan chose), against their plain
   versions, their bounds and, where a stage is a bare convolution,
   ``F.conv1d`` / ``F.conv2d``; beside the CUDA-event time of each loop the
   host's time to enqueue it and the device's busy time in it by kernel
   (``torch.profiler``), which say whether the host or the card paces it;
   the ``join`` launch plans, and the host's time in one call of each
   ``join`` wrapper; the fused step against the stock-op step in
   alternating turns, and the profiler's breakdown of the fused step;
11. the other two lowerings of the serving attention: the v1 kernel (on a
   precomputed QKV projection, rounded to the storage type) and the
   one-launch dual kernel against their plain versions at
   ``[4096, 15, 20, 64]`` and at batch 7, fp32 and bf16, the dual kernel
   also against the v2 kernel (equal bits), a second v1 launch bit-equal to
   the first; each axis's ``v1_plan`` printed, and the v1 kernel again at
   batch 1001, whose tiles leave its persistent grid's last round
   part-filled on both axes (batch 7's do not: a block a tile, one round);
   ``fast_forward(attention_impl="dual")`` must
   launch the dual kernel once and the v2 and v1 kernels never,
   ``attention_impl="v1"`` the v1 kernel twice, and both agree with the
   plain-torch module;
12. MM-Fi serving: the default ``MMFiModelConfig`` (bf16) with seeded
   weights at batch 4096; the three serving kernels against their plain
   versions at its shapes (TCN ``[4096, 10, 342]`` -> 342 -> 306 -> 288 with
   18 groups, conv stack ``[40960, 272]``, attention ``[4096, 17, 10, 64]``)
   and at part-filled blocks, and the random-weight checks of phase 2
   (attention included) at its widths; ``fast_forward_mmfi`` (3 + 1 + 2
   launches)
   against the plain-torch ``WiFlowMMFiModel`` at batch 4096 and 7; the
   MM-Fi metrics of the served batch on the card against the same on the
   CPU;
13. timings: the v1 and dual kernels against their plain versions, their
   bounds and, for v1, ``scaled_dot_product_attention``; ``fast_forward``
   under ``"v2"``, ``"dual"`` and ``"v1"`` in alternating turns;
   ``fast_forward_mmfi`` in frames/s beside the plain module, and the
   three serving kernels at the MM-Fi shapes with their bounds.
14. the CLI on the card, in a temporary directory: ``python -m
   wiflow_tpu_torch.cli.run --synthetic --epochs 2 --batch_size 64
   --use_augmentation --no_videos`` as a subprocess (the flagship
   ``ModelConfig`` at full width, bf16, on 20 synthetic files x 200
   frames = 3,620 windows) must exit 0 and write the best weights
   (``.pth``, ``.msgpack``), the resume bundle and the four CSVs (the PNG
   where matplotlib imports, else its skip line); ``cli.run.main`` with
   the same flags and ``--epochs 3`` in this process must resume at epoch
   3, keep the first run's two history rows exactly, launch each train
   kernel twice a step (the counters reset before and read after it) and
   take its second, augmented step with host syncs forbidden; a run of 3
   epochs into a second directory, never stopped, must end with the
   resumed run's history and weights bit for bit (or, where the card
   does not repeat itself, within twice the difference between two
   uninterrupted runs, printed beside it); the trained ``.pth`` served by
   ``fast_forward`` in bf16 at batch 4096 (the test split's windows,
   repeated) must hold the plain fp32 module at ``TOL_BF16`` with an
   output std over the batch of at least 1/100 of max|output| (3 epochs
   do not reach it: the resumed run goes on to ``SERVE_EPOCHS`` first, and
   says so), and the ``.msgpack`` must give the ``.pth``'s ``state_dict``
   bit for bit;
   seconds per epoch, training windows/s, the host's share of an epoch,
   the seconds to write the bundle and the best weights, and the first
   run's wall clock are printed.

Phases 11-13 belong to serving and share its weights and inputs, so they
run after phase 4, before the training phases; phase 14 runs last.  The last lines are the
card's name and power limit, the kernels' JSON record (13 rows), a summary
of the run (serving and step times, the steps' device busy time and the
train kernels' share of it, rows 6-9's device busy and CUDA-event times,
the ``logits_sums`` wrappers' host time) and ``{"ok": true, "device":
{...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory
# bytes/s and bf16 tensor-core FLOP/s; fp32 on CUDA cores for fp32 inputs.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances, as max|kernel - plain| <= TOL * max|plain|:
# fp32 — the kernel and the plain version do the same fp32 arithmetic in
# another summation order (sums of up to ~600 terms): 1e-4.
# bf16 — against the fp32 plain version: inputs, weights and each stored
# intermediate are rounded to bf16 (8-bit mantissa, 2^-9 relative), up to
# three times per TCN level and conv block; on an H100 the largest error
# seen was 7.1e-3 of max|ref| (the plain module in bf16): 2e-2.
TOL_F32 = 1e-4
TOL_BF16 = 2e-2

# The serving path's batch (``bench.py``'s serving measurement), the train
# step's batch (``bench.py``'s train measurement), the windows the training
# phase trains on, the CUDA-event timings per median, and the seed of
# weights and inputs.
BATCH = 4096
TRAIN_BATCH = 256
DEFAULT_BATCH = 64          # ``TrainConfig``'s default (core/config.py)
TRAIN_WINDOWS = 4096
RUNS = 20
SEED = 0
# Rounds of the train step's kernel-vs-plain comparison (phase 7).
STEP_ROUNDS = 6
# The train kernels: their names in the record, and their attributes in
# ``ops/kernels/axial_attention_train.py``.
KERNEL_ATTRS = {"axial_core_fwd": "CORE_FORWARD",
                "axial_core_bwd": "CORE_BACKWARD",
                "logits_sums_fwd": "SUMS_FORWARD",
                "logits_sums_bwd": "SUMS_BACKWARD"}
TRAIN_KERNELS = tuple(KERNEL_ATTRS)
# The stage-fused kernels: their names in the record, and their attributes
# in ``ops/kernels/stage_fused.py``; their launches in one train step of
# the default model (TCN: 4 convs a level and a shortcut conv on 3 levels,
# one join a level; conv stack: 5 blocks of 4 convs and a join).
STAGE_ATTRS = {"stage_fwd": "STAGE_FORWARD", "stage_bwd": "STAGE_BACKWARD",
               "join_fwd": "JOIN_FORWARD", "join_bwd": "JOIN_BACKWARD"}
STAGE_LAUNCHES = {"stage_fwd": 39, "stage_bwd": 39, "join_fwd": 9,
                  "join_bwd": 9}
FUSED = dict(tcn_train_impl="fused", conv_train_impl="fused")
# Samples of the MM-Fi geometries that phase 8 holds (correctness only).
MMFI_STAGE_BATCH = 33
# A batch at which the v1 kernel's persistent grid ends in a part-filled
# round on both axes of the flagship's attention (3754 and 4004 tiles on
# 264 blocks in bf16, on 132 in fp32); batch 7 is not one: its 27 and 28
# tiles take a block each, in one round.
V1_ROUND_BATCH = 1001
# Libraries whose tensor-core instructions phase 1 counts in the SASS, and
# those of them whose kernels must use the tensor cores in bf16, with this
# many HMMA (one projection, two; none in ``axial_attention_v1``, whose
# projection is outside, nor in ``logits_sums``, whose products are 8 x 8),
# and never in fp32 (no TF32), which phase 1 asserts.
SASS_LIBRARIES = ("conv_stack", "tcn_level", "stage_fused", "axial_attention",
                  "axial_attention_dual", "axial_attention_v1", "axial_core",
                  "logits_sums")
SASS_CHECKED = {"axial_attention": 126, "axial_attention_dual": 252,
                "axial_attention_v1": 0, "logits_sums": 0}
SASS_OPS = ("HMMA", "HGMMA")
# The random-weight checks of the redesigned serving kernels: the spread of
# the reference over rows must be at least this share of its largest value
# (seeded model weights give nearly one output for every row).
MIN_SPREAD = 1e-2


# Phase 14: the CLI's flags for the first run (2 epochs) and the rest (3),
# the files the first run must write, and the batch of the served check.
CLI_FLAGS = ["--synthetic", "--batch_size", "64", "--use_augmentation",
             "--no_videos"]
CLI_FILES = ("best_pose_model.pth", "best_pose_model.msgpack",
             "latest_checkpoint.pkl", "training_history.csv",
             "test_predictions.csv", "keypoint_error_stats.csv",
             "test_results_summary.csv")
CLI_TIMEOUT = 600
# Epochs the resumed run is carried on to before its best weights are
# served again when 3 leave the output's spread below the bar, as they do
# on the H100 (``PERF.md``): the synthetic data's val MPE first
# improves on epoch 3's well after epoch 20 at the default lr.
SERVE_EPOCHS = 40


# Short readings of the run, printed together just before the last line,
# where the end of a long output keeps them.
SUMMARY: list[str] = []


def log(*a):
    print(*a, flush=True)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor,
            tol: float) -> float:
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    limit = tol * scale
    log(f"  {name}: max_abs_err={err:.6e} max_rel_err={err / scale:.6e} "
        f"(max|ref|={scale:.4e}) limit={limit:.3e} "
        f"[tol {tol:g} x max|ref|] {'ok' if err <= limit else 'FAIL'}")
    if err > limit:
        raise AssertionError(f"{name}: {err} > {limit}")
    return err


def time_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_step_ms(fn, runs: int, warmup: int = 3) -> tuple[float, float]:
    """Medians of ``runs`` CUDA-event timings of ``fn()`` and of the host's
    time until ``fn()`` returns, each run from an idle device, after
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    device, host = [], []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b))
    return statistics.median(device), statistics.median(host)


def nontrivial_stats(model: torch.nn.Module, scale: float = 0.2) -> None:
    """Perturb BN running stats so the folding is exercised."""
    with torch.no_grad():
        for k, v in model.state_dict().items():
            i = torch.arange(v.numel(), device=v.device, dtype=torch.float32)
            if k.endswith("running_mean"):
                v.add_(scale * torch.sin(i))
            elif k.endswith("running_var"):
                v.mul_(1.0 + 0.5 * torch.cos(i) ** 2)


def tcn_work(cfg, batch, esize):
    """(FLOPs, bytes) of the TCN level launches of ``cfg`` (a ``ModelConfig``
    or an ``MMFiModelConfig``, whose antennas are flattened into the
    channels)."""
    t, g = cfg.window_size, cfg.tcn_groups
    flops = nbytes = 0
    cin = getattr(cfg, "input_channels", cfg.num_subcarriers)
    for cout in cfg.tcn_channels:
        ds = cin * cout if cin != cout else 0
        # one multiply-add per weight at each (sample, step)
        weights = 3 * cin * (cin // g) + cin * cout + 3 * cout * (cout // g) \
            + cout * cout + ds
        flops += 2 * batch * t * weights
        nbytes += batch * t * (cin + cout) * esize + weights * esize \
            + 4 * (cin + 3 * cout + (cout if ds else 0))
        cin = cout
    return flops, nbytes


def conv_work(cfg, rows, esize):
    """(FLOPs, bytes) of the conv-stack launch; its rows are the TCN's
    output features or, for MM-Fi, the projection's."""
    w, ci = conv_width(cfg), 1
    macs = weights = 0
    w_in = w
    for k, co in enumerate((cfg.conv_channels[0],) + tuple(cfg.conv_channels)):
        wout = w if k == 0 else (w - 1) // 2 + 1
        macs += 3 * ci * co * wout + 2 * 3 * co * co * wout + ci * co * wout
        weights += 3 * ci * co + 6 * co * co + ci * co
        ci, w = co, wout
    nbytes = rows * (w_in + ci * w) * esize + weights * esize + 4 * 16 * ci
    return 2 * rows * macs, nbytes


def attention_work(cfg, batch, esize):
    """(FLOPs, bytes) of the two attention launches."""
    c, g = cfg.conv_channels[-1], cfg.attention_groups
    h, w = cfg.num_keypoints, cfg.window_size
    flops = 0
    for length in (w, h):
        n = batch * h * w // length
        flops += 2 * n * length * c * 3 * c            # QKV projection
        flops += 2 * 2 * n * g * length * length * (c // g)   # logits, p @ v
    nbytes = 2 * (2 * batch * h * w * c * esize + 3 * c * c * esize
                  + 4 * (3 * c + 2 * g + 2 * c))
    return flops, nbytes


def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_report(log_text: str):
    """(kernel, line) for each registers or spill line of nvcc's ``-Xptxas
    -v`` report, under the entry function ptxas names before it
    (demangled with ``cu++filt`` or ``c++filt`` where one is installed)."""
    rows, name = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
        elif "registers" in line or "spill" in line:
            rows.append((name, line.split(":", 1)[-1].strip()))
    names = sorted({n for n, _ in rows})
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    readable = dict(zip(names, names))
    if tool and names:
        out = subprocess.run([tool], input="\n".join(names), text=True,
                             capture_output=True).stdout.splitlines()
        if len(out) == len(names):
            readable = dict(zip(names, out))
    return [(readable[n], line) for n, line in rows]


def sass_counts(library):
    """(kernel, {opcode: count}) of the tensor-core instructions (``HMMA``
    from mma.sync, ``HGMMA`` from wgmma) in each kernel of a built library,
    from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                     "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    rows, name, counts = [], None, {}
    for line in text.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name is not None:
                rows.append((name, counts))
            name, counts = m.group(1), {op: 0 for op in SASS_OPS}
            continue
        m = re.search(r"\b(HGMMA|HMMA)\.", line)
        if m and name is not None:
            counts[m.group(1)] += 1
    names = [n for n, _ in rows]
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool and names:
        out = subprocess.run([tool], input="\n".join(names), text=True,
                             capture_output=True).stdout.splitlines()
        if len(out) == len(names):
            rows = [(o, c) for o, (_, c) in zip(out, rows)]
    return rows


def compare_leaves(what, got, ref, tol, floor_frac):
    """``compare`` over named tensors, each leaf held to ``tol`` times the
    larger of its own max|ref| and ``floor_frac`` of the largest max|ref|
    of all leaves (leaves that are 0 in exact arithmetic, such as a conv
    bias before a BatchNorm, carry only rounding noise).  Logs the leaf
    closest to its limit."""
    scale = {n: ref[n].float().abs().max().item() for n in ref}
    floor = floor_frac * max(scale.values())
    worst, worst_ratio = None, -1.0
    for n in ref:
        err = (got[n].float() - ref[n].float()).abs().max().item()
        limit = tol * max(scale[n], floor)
        if not torch.isfinite(got[n]).all() or err > limit:
            raise AssertionError(f"{what} {n}: {err} > {limit}")
        if err / limit > worst_ratio:
            worst, worst_ratio = (n, err, limit), err / limit
    n, err, limit = worst
    log(f"  {what}: {len(ref)} leaves ok [tol {tol:g} x max(max|ref|, "
        f"{floor_frac:g} x largest)]; closest {n}: max_abs_err={err:.6e} "
        f"limit={limit:.3e}")


def train_axes():
    """(label, sequences, length, main) of the train kernels' launches: both
    axes of the ``[256, 15, 20, 64]`` attention input (``main``: the train
    step's), both of the MM-Fi model's ``[256, 17, 10, 64]``, both of the
    flagship's at ``TrainConfig``'s default batch (``DEFAULT_BATCH``; the
    ``logits_sums`` kernels split the width axis's positions over 2
    ranges), then 7 sequences at each length, which leave the last tile
    part-filled (4 ranges)."""
    axes = []
    for model, (h, w) in (("", (15, 20)), ("MM-Fi ", (17, 10))):
        axes += [(f"{model}width", TRAIN_BATCH * h, w, not model),
                 (f"{model}height", TRAIN_BATCH * w, h, not model)]
    axes += [(f"width, batch {DEFAULT_BATCH}", DEFAULT_BATCH * 15, 20, False),
             (f"height, batch {DEFAULT_BATCH}", DEFAULT_BATCH * 20, 15,
              False)]
    return axes + [(f"L={length}, 7 seqs", 7, length, False)
                   for length in (20, 15, 10, 17)]


def train_work(kind, shapes, c, g, esize):
    """(FLOPs, bytes) of one train kernel over ``shapes`` [(n, L)]: each
    multiply-add of q.k, p.v and their gradients counts 2, each input
    byte is read once and each output written once."""
    flops = nbytes = 0
    for n, length in shapes:
        pairs, rows = n * length * length, n * length * c * esize
        if kind == "axial_core_fwd":       # logits, p @ v; q, k, v -> out
            flops += 4 * pairs * c
            nbytes += 4 * rows + 4 * g
        elif kind == "axial_core_bwd":     # logits, dsim, dq, dk, dv
            flops += 10 * pairs * c
            nbytes += 7 * rows + 8 * g
        elif kind == "logits_sums_fwd":    # logits, their sum and square
            flops += 2 * pairs * c + 3 * pairs * g
            nbytes += 2 * rows + 8 * g
        else:                              # logits, dq, dk
            flops += 6 * pairs * c
            nbytes += 4 * rows + 8 * g
    return flops, nbytes


@contextlib.contextmanager
def plain_attention():
    """Run the model's train-mode attention through the plain versions of
    its kernels, for the comparisons and timings of phases 6 and 7."""
    import wiflow_tpu_torch.models.wiflow as wiflow
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
    saved = wiflow.axial_core, wiflow.logits_moments_fused
    wiflow.axial_core = tk.axial_core_plain
    wiflow.logits_moments_fused = (
        lambda q, k, groups, count: tk.logits_moments(q, k, groups))
    try:
        yield
    finally:
        wiflow.axial_core, wiflow.logits_moments_fused = saved


def host_ms(fn, runs: int = 50) -> float:
    """Median host time of one ``fn()`` from an idle device: what a call
    takes to check its inputs and enqueue its launches."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def sums_elsewhere(tk, q, k, g):
    """``logits_sums_forward`` on a stream of its own (a workspace of its
    own), then captured there in a CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = tk.logits_sums_forward(q, k, g)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        replayed = tk.logits_sums_forward(q, k, g)
    graph.replay()
    torch.cuda.synchronize()
    return [eager, replayed.clone()]


def check_train_kernels(dev, c, g):
    """Phase 5.  Returns the bf16 inputs of the two main axes (for the
    timings of phase 7) and each kernel's largest bf16 error on them."""
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
    from wiflow_tpu_torch.ops.kernels.build import sm_count
    log(f"phase 5: train kernels vs plain versions, batch {TRAIN_BATCH} "
        f"shapes")
    from wiflow_tpu_torch.core.config import TrainConfig
    assert TrainConfig().batch_size == DEFAULT_BATCH
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    errs = dict.fromkeys(TRAIN_KERNELS, 0.0)
    main16 = []
    for label, n, length, main in train_axes():
        plan = tk.train_attention_plan(n, length, c, g, torch.bfloat16,
                                       sm_count(0))
        splan = tk.sums_plan(n, length, c, g, torch.bfloat16, sm_count(0))
        log(f"  {label}: n={n}, L={length}; axial_core's bf16 plan {plan}; "
            f"logits_sums' {splan}")
        qkv = torch.randn((n, length, 3 * c), generator=gen, device=dev)
        scale = torch.empty(g, device=dev).uniform_(0.25, 0.45, generator=gen)
        dout = torch.randn((n, length, c), generator=gen, device=dev)
        dsums = torch.randn((2, g), generator=gen, device=dev)

        def plain(fn, leaves, cot, dt):
            leaves = [t.detach().to(dt).requires_grad_(True) for t in leaves]
            out = fn(*leaves)
            return (out.detach(),
                    *torch.autograd.grad(out, leaves, cot.to(out.dtype)))

        q, k, v = qkv.split(c, dim=-1)
        core32 = plain(tk.axial_core_plain, (q, k, v, scale), dout,
                       torch.float32)
        core64 = plain(tk.axial_core_plain, (q, k, v, scale), dout,
                       torch.float64)
        sums_fn = lambda a, b: tk.logits_sums_plain(a, b, g)  # noqa: E731
        sums32 = plain(sums_fn, (q, k), dsums, torch.float32)
        sums64 = plain(sums_fn, (q, k), dsums, torch.float64)
        for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            tag = f"{label}, {'fp32' if dt == torch.float32 else 'bf16'}"
            qt, kt, vt = qkv.to(dt).split(c, dim=-1)   # thirds, read in place
            e_out = tk.axial_core_forward(qt, kt, vt, scale)
            e = {"axial_core_fwd": compare(f"axial_core fwd {tag}", e_out,
                                           core32[0], tol)}
            grads = tk.axial_core_backward(qt, kt, vt, scale, dout.to(dt))
            same_bits(f"axial_core fwd {tag}, a second launch",
                      [tk.axial_core_forward(qt, kt, vt, scale)], [e_out])
            same_bits(f"axial_core bwd {tag}, a second launch",
                      tk.axial_core_backward(qt, kt, vt, scale, dout.to(dt)),
                      grads)
            log(f"  axial_core fwd and bwd {tag}: a second launch equal bit "
                f"for bit")
            e["axial_core_bwd"] = max(
                [compare(f"axial_core bwd {x} {tag}", got, ref, tol)
                 for x, got, ref in zip(("dq", "dk", "dv"), grads,
                                        core32[1:4])]
                + [compare(f"axial_core bwd dscale {tag} vs float64",
                           grads[3], core64[4], tol)])
            sums = tk.logits_sums_forward(qt, kt, g)
            e["logits_sums_fwd"] = max(
                compare(f"logits_sums fwd {x} {tag} vs float64", sums[i],
                        sums64[0][i], tol)
                for i, x in enumerate(("sum", "sum of squares")))
            dq, dk = tk.logits_sums_backward(qt, kt, dsums)
            e["logits_sums_bwd"] = max(
                compare(f"logits_sums bwd dq {tag}", dq, sums32[1], tol),
                compare(f"logits_sums bwd dk {tag}", dk, sums32[2], tol))
            same_bits(f"logits_sums fwd {tag}, a second launch",
                      [tk.logits_sums_forward(qt, kt, g)], [sums])
            same_bits(f"logits_sums bwd {tag}, a second launch",
                      tk.logits_sums_backward(qt, kt, dsums), (dq, dk))
            log(f"  logits_sums fwd and bwd {tag}: a second launch equal bit "
                f"for bit")
            if main:
                same_bits(f"logits_sums fwd {tag}, on another stream and "
                          f"replayed from a CUDA graph",
                          sums_elsewhere(tk, qt, kt, g), [sums, sums])
                log(f"  logits_sums fwd {tag}: on another stream and "
                    f"replayed from a CUDA graph, equal bit for bit")
            if dt == torch.bfloat16 and main:
                errs = {x: max(errs[x], e[x]) for x in errs}
        if main:
            main16.append((qkv.to(torch.bfloat16), scale,
                           dout.to(torch.bfloat16), dsums))
    torch.cuda.synchronize()
    return main16, errs


def train_data(dev, cfg):
    """``TRAIN_WINDOWS`` seeded bf16 windows and their targets: a fixed
    seeded function of the window, to be learned."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    c_in, kp = cfg.num_subcarriers, cfg.num_keypoints
    xs = torch.randn((TRAIN_WINDOWS, c_in, cfg.window_size), generator=gen,
                     device=dev).to(torch.bfloat16)
    proj = torch.randn((c_in, 2 * kp), generator=gen, device=dev) / c_in ** 0.5
    ys = (0.3 * torch.tanh(4.0 * xs.float().mean(dim=2) @ proj)).reshape(
        TRAIN_WINDOWS, kp, 2)
    return xs, ys


def run_training(dev, all_kernels, cfg, xs, ys, expect):
    """Train ``cfg`` for 2 epochs of 16 steps, then one ``train_pose_model``
    epoch.  The first step must launch each kernel of ``expect`` that often
    and no other kernel; the second runs with host syncs forbidden; the loss
    must descend.  Returns the train state and the first step's launches."""
    from wiflow_tpu_torch.core.config import Config, OptimConfig, TrainConfig
    from wiflow_tpu_torch.train.loop import train_pose_model
    from wiflow_tpu_torch.train.steps import (
        create_train_state, make_batch_indices, train_step,
    )
    state = create_train_state(cfg, OptimConfig(), seed=SEED, device=dev)
    shuffle = torch.Generator().manual_seed(SEED)
    losses, launches = [], None
    for _ in range(2):
        idx = make_batch_indices(TRAIN_WINDOWS, TRAIN_BATCH, torch.randperm(
            TRAIN_WINDOWS, generator=shuffle)).to(dev)
        for bi in idx:
            if launches is None:
                reset_launches(all_kernels)
                m = train_step(state, xs[bi], ys[bi])
                launches = read_launches(all_kernels)
                expect_launches("one train step", launches, expect)
            elif len(losses) == 1:
                # the second step must not wait on the device: torch
                # raises on any synchronizing call in this mode
                torch.cuda.set_sync_debug_mode("error")
                try:
                    m = train_step(state, xs[bi], ys[bi])
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                log("  one train step ran with no host sync "
                    "(torch.cuda.set_sync_debug_mode('error'))")
            else:
                m = train_step(state, xs[bi], ys[bi])
            losses.append(m["loss"])
    losses = torch.stack(losses).cpu()
    log("  loss per step: " + " ".join(f"{v:.4f}" for v in losses.tolist()))
    first, last = losses[:8].mean().item(), losses[-8:].mean().item()
    log(f"  mean loss of the first 8 steps {first:.6f}, of the last 8 "
        f"{last:.6f}")
    if not torch.isfinite(losses).all() or not last < first:
        raise AssertionError("the loss is not finite or did not descend")

    kp = cfg.num_keypoints
    split = [(xs[a:b].float().cpu().numpy(), ys[a:b].cpu().numpy())
             for a, b in ((0, 2048), (2048, 2560), (2560, 3072))]
    res = train_pose_model(*split, Config(model=cfg, train=TrainConfig(
        batch_size=TRAIN_BATCH, num_epochs=1)), device=dev)
    if (res.epochs_run != 1 or res.predictions.shape != (512, kp, 2)
            or not all(map(math.isfinite, res.test_metrics.values()))):
        raise AssertionError(f"train_pose_model: {res.epochs_run} epochs, "
                             f"{res.predictions.shape}, {res.test_metrics}")
    log(f"  train_pose_model: 1 epoch in {res.wall_clock_sec:.2f} s, test "
        f"{json.dumps(res.test_metrics)}")
    return state, launches


def fp32_step(dev, cfg, xb, yb, ctx=None):
    """One fp32 train step of ``cfg`` on ``dev`` with the weights and
    dropout masks of ``SEED`` (cuDNN deterministic, so that two runs differ
    only in what is named): its metrics, every gradient leaf and every
    running statistic."""
    from wiflow_tpu_torch.core.config import OptimConfig
    from wiflow_tpu_torch.train.steps import create_train_state, train_step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        st = create_train_state(cfg, OptimConfig(), seed=SEED, device=dev)
        with ctx or contextlib.nullcontext():
            m = train_step(st, xb.to(dev), yb.to(dev))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return (m, {n: p.grad for n, p in st.model.named_parameters()},
            {n: b for n, b in st.model.named_buffers() if "running" in n})


# Floors of ``compare_leaves`` for a train step's gradients and running
# statistics.
GRAD_FLOOR, STAT_FLOOR = 1e-2, 1e-3


def compare_fp32_steps(what, got, ref, tol=TOL_F32):
    """Hold one ``fp32_step`` to another: the loss parts to ``TOL_F32``,
    the gradient norm, every gradient leaf and every running statistic to
    ``tol``."""
    (mk, gk, bk), (mp, gp, bp) = got, ref
    for key in ("loss", "position", "bone", "mpe"):
        compare(f"train step fp32 {key}, {what}", mk[key], mp[key], TOL_F32)
    compare(f"train step fp32 grad_norm, {what}", mk["grad_norm"],
            mp["grad_norm"], tol)
    compare_leaves(f"train step fp32 gradients, {what}", gk, gp, tol,
                   GRAD_FLOOR)
    compare_leaves(f"train step fp32 running statistics, {what}", bk, bp,
                   tol, STAT_FLOOR)


def leaf_noise(got, ref, floor_frac):
    """The largest error of a leaf of ``got`` against ``ref`` (tensors on
    any devices), relative to the scale ``compare_leaves`` holds it to."""
    scale = {n: ref[n].float().abs().max().item() for n in ref}
    floor = floor_frac * max(scale.values())
    return max((got[n].float().cpu() - ref[n].float().cpu()).abs().max().item()
               / max(scale[n], floor) for n in ref)


def train_slice(dev, all_kernels):
    """Phase 6.  Returns the bf16 train state, the training data, and the
    launches of one train step."""
    from wiflow_tpu_torch.core.config import ModelConfig, OptimConfig
    cfg = ModelConfig()
    log(f"phase 6: training, default ModelConfig ({cfg.compute_dtype}, "
        f"dropout {cfg.dropout}/{cfg.conv_dropout}), AdamW "
        f"{OptimConfig().lr:g}, batch {TRAIN_BATCH}, 2 epochs over "
        f"{TRAIN_WINDOWS} windows")
    xs, ys = train_data(dev, cfg)
    state, launches = run_training(dev, all_kernels, cfg, xs, ys,
                                   dict.fromkeys(TRAIN_KERNELS, 2))
    # one fp32 step without dropout, through the plain versions of the
    # attention kernels and through the kernels
    cfg32 = ModelConfig(compute_dtype="float32", dropout=0.0,
                        conv_dropout=0.0)
    xb, yb = xs[:TRAIN_BATCH].float(), ys[:TRAIN_BATCH]
    compare_fp32_steps("kernels vs plain", fp32_step(dev, cfg32, xb, yb),
                       fp32_step(dev, cfg32, xb, yb, plain_attention()))
    return state, xs, ys, launches


# Classes of device kernels in the train step's profile, by a word in the
# kernel's name (first match wins).
KERNEL_CLASSES = (
    ("the port's stage and join kernels", (
        "stage_conv_kernel", "stage_stream_kernel", "stage_direct_kernel",
        "stage_wgrad_kernel", "join_forward_kernel", "join_backward_kernel",
        "reduce_rows", "reduce_affine_grads")),
    ("the port's train kernels", ("core_forward_kernel",
                                  "core_backward_kernel",
                                  "sums_forward_kernel",
                                  "sums_backward_kernel", "reduce_columns")),
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "wgrad",
                              "dgrad", "fprop")),
    ("matmuls", ("gemm", "cutlass")),
    ("optimizer and clip (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill", "catarray")),
)


def profile_step(step, step_ms: float, runs: int = 5, top: int = 20,
                 what: str = "step") -> None:
    """Log the device time of ``step()`` (``torch.profiler``, per step):
    the device's busy and idle shares of the step, the time by class of
    kernel and the largest kernels; the busy time and the train kernels'
    go to ``SUMMARY`` under ``what``.  Only device-side kernels and copies
    count: the CPU ops that launch them, and the device-side spans of
    ``record_function`` annotations (``Optimizer.step``), carry the same
    time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CPU
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / runs / 1e3, e.count / runs, e.key))
    if not rows:
        log("  torch.profiler recorded no device time")
        return
    busy = sum(r[0] for r in rows)
    log(f"  torch.profiler, {runs} steps: device busy {busy:.4f} ms per "
        f"step = {busy / step_ms:.1%} of the {step_ms:.4f} ms step (idle "
        f"{1 - busy / step_ms:.1%}), {sum(r[1] for r in rows):g} device "
        f"events per step")
    by_class = {}
    for ms, count, key in rows:
        name = key.lower()
        cls = next((c for c, words in KERNEL_CLASSES
                    if any(w in name for w in words)), "other")
        t, n = by_class.get(cls, (0.0, 0.0))
        by_class[cls] = (t + ms, n + count)
    for cls, (ms, count) in sorted(by_class.items(), key=lambda r: -r[1][0]):
        log(f"    {ms:8.4f} ms {ms / busy:6.1%} x{count:g} {cls}")
    ms, count = by_class.get("the port's train kernels", (0.0, 0))
    SUMMARY.append(f"{what} {step_ms:.4f} ms, device busy {busy:.4f}, train "
                   f"kernels {ms:.4f} x{count:g}")
    log("  largest kernels by self device time:")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"    {ms:8.4f} ms {ms / busy:6.1%} x{count:g} {key[:90]}")


def device_ms(fn, runs: int = 10, by_kernel=None) -> float:
    """The device's busy time in one ``fn()``: the sum of its kernels'
    durations (``torch.profiler``).  Unlike a CUDA-event timing it does not
    count the gaps that a slow host leaves between launches.  The profiler
    loses some of the first events of a short window, so a kernel counts
    with its mean duration times its launches per call, rounded from what
    was seen over ``runs`` calls.  ``by_kernel``, a dict, gets ``(ms,
    launches)`` per call by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CPU
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if us <= 0 or e.count < 1:
            continue
        launches = max(1, round(e.count / runs))
        ms = us / e.count * launches / 1e3
        total += ms
        if by_kernel is not None:
            by_kernel[e.key] = (ms, launches)
    return total


def train_timings(state, xb, yb, main16, c, g, launches, errs):
    """Phase 7: the train step, then each train kernel alone (both axes,
    as one train step launches it) against its plain version, its bound
    and, for ``axial_core``, ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
    from wiflow_tpu_torch.ops.kernels.build import sm_count
    from wiflow_tpu_torch.train.steps import train_step
    log(f"phase 7: train timings (CUDA events, median of {RUNS})")

    def kernel_step():
        train_step(state, xb, yb)

    def plain_step():
        with plain_attention():
            train_step(state, xb, yb)

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernel_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # The step waits on the host's launches, whose pace drifts within a
    # run: time the two paths in turns (kernels, plain, plain, kernels, ...)
    # and compare each round's pair.  Each turn also reads the host's time
    # until train_step returns (it holds no sync: the time to enqueue it).
    turns = {"kernels": [], "plain": []}
    for r in range(STEP_ROUNDS):
        for name in ("kernels", "plain")[::1 if r % 2 == 0 else -1]:
            turns[name].append(time_step_ms(
                kernel_step if name == "kernels" else plain_step, RUNS // 2))
    step_ms = statistics.median(t for t, _ in turns["kernels"])
    plain_step_ms = statistics.median(t for t, _ in turns["plain"])
    wins = sum(k < p for (k, _), (p, _) in zip(turns["kernels"],
                                                turns["plain"]))
    host_share = statistics.median(h / t for t, h in turns["kernels"])
    log(f"train step bf16 batch {TRAIN_BATCH} (forward, backward, clip, "
        f"AdamW), median of {STEP_ROUNDS} turns of {RUNS // 2} steps: "
        f"{step_ms:.4f} ms = {TRAIN_BATCH / step_ms * 1e3:.1f} windows/s; "
        f"with the plain attention versions: {plain_step_ms:.4f} ms = "
        f"{TRAIN_BATCH / plain_step_ms * 1e3:.1f} windows/s; the kernels "
        f"faster in {wins} of {STEP_ROUNDS} rounds; the host's time to "
        f"enqueue a step {host_share:.1%} of the step; peak device memory "
        f"of the step {peak / 2**30:.2f} GiB above the {base / 2**30:.2f} "
        f"GiB held before it")
    for name, ts in turns.items():
        log(f"  {name} per turn, step / enqueue ms: "
            + " ".join(f"{t:.4f}/{h:.4f}" for t, h in ts))
    profile_step(kernel_step, step_ms, what="stock-op step")

    def grad_graphs(fn, inputs):
        """Plain forward graphs to time the plain backward on."""
        graphs = []
        for leaves, cot in inputs:
            leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
            graphs.append((fn(*leaves), leaves, cot))
        return lambda: [torch.autograd.grad(o, lv, d, retain_graph=True)
                        for o, lv, d in graphs]

    core = [((*qkv.split(c, dim=-1), s), d) for qkv, s, d, _ in main16]
    pairs = [(tuple(qkv.split(c, dim=-1)[:2]), ds)
             for qkv, _, _, ds in main16]
    heads, grads = [], []
    for (q, k, v, s), d in core:
        n, length, _ = q.shape

        def split_heads(t):
            return t.reshape(n, length, g, c // g).transpose(1, 2).contiguous()
        qh = (split_heads(q).float() * s[None, :, None, None]).to(q.dtype)
        heads.append((qh, split_heads(k), split_heads(v), split_heads(d)))
        grads.append([t.clone().requires_grad_(True) for t in heads[-1][:3]]
                     + [heads[-1][3]])

    def sdpa_fwd_bwd():
        for qh, kh, vh, dh in grads:
            out = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
            torch.autograd.grad(out, (qh, kh, vh), dh)

    sums_fn = lambda a, b: tk.logits_sums_plain(a, b, g)  # noqa: E731
    cases = {
        "axial_core_fwd": (
            lambda: [tk.axial_core_forward(*a) for a, _ in core],
            lambda: [tk.axial_core_plain(*a) for a, _ in core],
            lambda: [F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
                     for qh, kh, vh, _ in heads]),
        "axial_core_bwd": (
            lambda: [tk.axial_core_backward(*a, d) for a, d in core],
            grad_graphs(tk.axial_core_plain, core), sdpa_fwd_bwd),
        "logits_sums_fwd": (
            lambda: [tk.logits_sums_forward(*a, g) for a, _ in pairs],
            lambda: [sums_fn(*a) for a, _ in pairs], None),
        "logits_sums_bwd": (
            lambda: [tk.logits_sums_backward(*a, d) for a, d in pairs],
            grad_graphs(sums_fn, pairs), None),
    }
    shapes = [(qkv.shape[0], qkv.shape[1]) for qkv, *_ in main16]
    for n, length in shapes:
        plan = tk.train_attention_plan(n, length, c, g, torch.bfloat16,
                                       sm_count(0))
        log(f"  axial_core's plan, n={n}, L={length}: {plan}")
    record = []
    for name, (kfn, pfn, lfn) in cases.items():
        ms = time_ms(kfn, RUNS)
        busy = device_ms(kfn)
        plain_ms = time_ms(pfn, max(3, RUNS // 4))
        lib_ms = time_ms(lfn, RUNS) if lfn else None
        flops, nbytes = train_work(name, shapes, c, g, 2)
        bms, by = bound_ms(flops, nbytes, torch.bfloat16)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"  {name} (both axes): kernel {ms:.4f} ms (device busy "
            f"{busy:.4f} ms), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {lib}, bound {bms:.4f} ms ({by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e9:.4f} GB)")
        kern = getattr(tk, KERNEL_ATTRS[name])
        record.append({"name": name, "route": "cuda", "source": kern.source,
                       "replaces": kern.replaces, "launches": launches[name],
                       "max_abs_err": errs[name], "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "library_ms": lib_ms, "device_busy_ms": busy})
        SUMMARY.append(f"{name} busy {busy:.4f} events {ms:.4f} ms")
    share = sum(r["ms"] for r in record)
    log(f"  the four train kernels alone: {share:.4f} ms = "
        f"{share / step_ms:.1%} of the train step")
    sums_host_times(main16[0][0].device, c, g)
    return record


def sums_host_times(dev, c, g):
    """The host's time in one call of each ``logits_sums`` wrapper on the
    bf16 thirds of a width-axis projection at batch 256: its checks, plan
    and launch.  It uses only the wrappers' interfaces, so it times any
    tree's: ``python3 -c "import chip_smoke as c; c.build_kernels(
    only=['logits_sums']); c.sums_host_times(torch.device('cuda'), 64,
    8)"``."""
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n, length = TRAIN_BATCH * 15, 20
    qkv = torch.randn((n, length, 3 * c), generator=gen, device=dev)
    q, k, _ = qkv.to(torch.bfloat16).split(c, dim=-1)
    d = torch.randn((2, g), generator=gen, device=dev)
    fwd = host_ms(lambda: tk.logits_sums_forward(q, k, g))
    bwd = host_ms(lambda: tk.logits_sums_backward(q, k, d))
    log(f"  logits_sums wrappers, host time a call (n={n}, L={length}, "
        f"bf16): forward {fwd:.4f} ms, backward {bwd:.4f} ms")
    SUMMARY.append(f"logits_sums host a call fwd {fwd:.4f} bwd {bwd:.4f} ms")


def case_label(c):
    if "kind" not in c:
        parts = [f"join {list(c['lead'])} x {c['c']}"]
        parts += [w for w, on in (("mask", c["mask"]),
                                  ("residual BN", c["res_norm"]),
                                  ("act_h", c["act_h"])) if on]
        return ", ".join(parts)
    head = f"{c['kind']} {list(c['lead'])} {c['ci']}->{c['co']}"
    if c["groups"] > 1:
        head += f" g{c['groups']}"
    if c["kind"] == "causal3":
        head += f" dil {c['dil']}"
    parts = [head] + [w for w, on in (
        ("prologue", c["pro"]), (f"{c['mask']} mask", c["mask"]),
        ("bias", c["bias"])) if on]
    return ", ".join(parts)


def bn_vectors(c, gen, dev):
    """Seeded ``(m, a, b)`` of a BatchNorm apply over ``c`` channels."""
    return (0.3 * torch.randn(c, generator=gen, device=dev),
            torch.empty(c, device=dev).uniform_(0.5, 1.5, generator=gen),
            0.3 * torch.randn(c, generator=gen, device=dev))


def keep_bits(mask, lead, c, gen, dev, keep):
    if mask is None:
        return None
    shape = (*lead, c) if mask == "element" else (lead[0], c)
    return torch.rand(shape, generator=gen, device=dev) < keep


def stage_inputs(c, gen, dev, keep):
    """Seeded fp32 inputs and cotangents of one stage launch."""
    ktaps = 1 if c["kind"] in ("identity", "chunk1") else 3
    cig = c["ci"] // c["groups"]
    x = torch.randn((*c["lead"], c["ci"]), generator=gen, device=dev)
    wshape = (c["co"], cig, ktaps) if len(c["lead"]) == 2 else (
        c["co"], cig, 1, ktaps)
    w = torch.randn(wshape, generator=gen, device=dev) / (cig * ktaps) ** 0.5
    m, a, b = bn_vectors(c["ci"], gen, dev) if c["pro"] else (None,) * 3
    mask = keep_bits(c["mask"], c["lead"], c["ci"], gen, dev, keep)
    bias = (0.1 * torch.randn(c["co"], generator=gen, device=dev)
            if c["bias"] else None)
    wout = (c["lead"][-1] - 1) // 2 + 1 if c["kind"].startswith(
        "chunk") else c["lead"][-1]
    go = 0.1 * torch.randn((*c["lead"][:-1], wout, c["co"]), generator=gen,
                           device=dev)
    gs = torch.stack([torch.randn(c["co"], generator=gen, device=dev),
                      0.01 * torch.randn(c["co"], generator=gen, device=dev)])
    return dict(x=x, m=m, a=a, b=b, mask=mask, w=w, bias=bias, go=go, gs=gs)


def join_inputs(c, gen, dev, keep):
    shape = (*c["lead"], c["c"])
    h = torch.randn(shape, generator=gen, device=dev)
    res = torch.randn(shape, generator=gen, device=dev)
    vh = bn_vectors(c["c"], gen, dev)
    vr = bn_vectors(c["c"], gen, dev) if c["res_norm"] else (None,) * 3
    mask = keep_bits(c["mask"], c["lead"], c["c"], gen, dev, keep)
    go = 0.1 * torch.randn(shape, generator=gen, device=dev)
    return dict(h=h, vh=vh, mask=mask, res=res, vr=vr, go=go)


def plain_grads(fn, leaves, cots, dt):
    """``fn`` on the floating leaves cast to ``dt``: its outputs and the
    gradient of every leaf under the cotangents ``cots``."""
    leaves = [None if t is None else t.detach().to(dt).requires_grad_(True)
              for t in leaves]
    outs = fn(*leaves)
    live = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(
        outs, live, [g.to(o.dtype) for g, o in zip(cots, outs)]))
    return ([o.detach() for o in outs],
            [None if t is None else next(grads) for t in leaves])


def worst(name, pairs, tol):
    """Hold every (label, got, ref) to ``tol`` x max|ref|; log one line
    with the pair closest to its limit and return the first pair's error
    (the kernel's main output)."""
    rows = []
    for label, got, ref in pairs:
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: shape {tuple(got.shape)} "
                                 f"vs {tuple(ref.shape)}, or not finite")
        err = (got.double() - ref.double()).abs().max().item()
        limit = tol * ref.double().abs().max().item()
        if not err <= limit:
            raise AssertionError(f"{name} {label}: {err} > {limit}")
        rows.append((err / limit if limit else 0.0, label, err, limit))
    ratio, label, err, limit = max(rows)
    log(f"  {name}: {len(rows)} results ok [tol {tol:g} x max|ref|]; closest "
        f"{label}: max_abs_err={err:.6e} limit={limit:.3e}")
    return rows[0][2]


def same_bits(name, first, second):
    """A second launch on the same inputs must repeat the first bit for
    bit: the kernels' reductions add in a fixed order and use no atomics."""
    for a, b in zip(first, second):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 f"differ")


def check_stage_kernels(dev, cfg):
    """Phase 8.  Returns each kernel's largest bf16 error at the batch-256
    shapes: of ``out`` for a forward, of the input gradient for a
    backward."""
    from wiflow_tpu_torch.ops.kernels import stage_fused as sk
    log(f"phase 8: stage and join kernels vs plain versions, batch "
        f"{TRAIN_BATCH} shapes, 7 samples and the MM-Fi geometries at "
        f"{MMFI_STAGE_BATCH} samples")
    keep = 1.0 - cfg.dropout
    stages, joins = sk.step_launches(cfg, TRAIN_BATCH)
    small_s, small_j = sk.step_launches(cfg, 7)

    def pick(cases, **want):
        return next(c for c in cases
                    if all(c[k] == v for k, v in want.items()))

    stage_cases = [
        pick(stages, kind="causal3", ci=540, dil=1),
        pick(stages, kind="causal3", ci=240, dil=8, pro=True),
        pick(stages, kind="identity", ci=540, co=540, pro=True),
        pick(stages, kind="identity", ci=540, co=440, pro=True),
        pick(stages, kind="sym3", ci=8, co=8, lead=(TRAIN_BATCH, 20, 240)),
        pick(stages, kind="sym3", ci=64, co=64),
        pick(stages, kind="chunk3", ci=8, co=8),
        pick(stages, kind="chunk3", ci=32, co=64),
        pick(stages, kind="chunk1", ci=8, co=8),
        pick(stages, kind="chunk1", ci=32, co=64),
        pick(stages, kind="sym3", ci=1, co=8),
        # 7 samples: the last block of every launch is part-filled
        pick(small_s, kind="causal3", ci=440, dil=2, pro=True),
        pick(small_s, kind="identity", ci=540, co=440, pro=True),
        pick(small_s, kind="sym3", ci=64, co=64),
        pick(small_s, kind="chunk3", ci=32, co=64),
        pick(small_s, kind="chunk1", ci=32, co=64),
        # the MM-Fi model's geometries (T = 10; 19, 17 and 16 channels a
        # group of 18; conv rows of 272 to 17 positions)
        *sk.mmfi_stage_cases(MMFI_STAGE_BATCH),
        # rows too long for one tile: cut in strips that share a halo
        dict(kind="sym3", lead=(3, 2, 2500), ci=8, co=8, groups=1, dil=1,
             pro=True, mask="sample", bias=True, need_gx=True),
        dict(kind="chunk3", lead=(3, 2, 2500), ci=8, co=16, groups=1, dil=1,
             pro=False, mask=None, bias=True, need_gx=True),
    ]
    join_cases = [
        # every join of the step: 4-channel chunks at 540 and 340, 8 at
        # the others, rows cut in slices for the backward's finish
        *joins,
        pick(small_j, c=240), pick(small_j, c=16),
        # the MM-Fi TCN's widths (2-channel chunks) with element masks
        dict(lead=(MMFI_STAGE_BATCH, 10), c=342, mask="element",
             res_norm=False, act_h=True),
        dict(lead=(MMFI_STAGE_BATCH, 10), c=306, mask="element",
             res_norm=True, act_h=True),
        # one channel a chunk, a per-sample mask; the combinations the
        # default model does not use
        dict(lead=(7, 20), c=17, mask="sample", res_norm=True, act_h=True),
        dict(lead=(7, 20), c=340, mask=None, res_norm=False, act_h=False),
        dict(lead=(7, 20, 30), c=32, mask="sample", res_norm=True,
             act_h=True),
    ]
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    errs = dict.fromkeys(STAGE_ATTRS, 0.0)
    names = ("gx", "g_m", "g_a", "g_b", "gw", "gbias")
    for c in stage_cases:
        i = stage_inputs(c, gen, dev, keep)
        kw = dict(kind=c["kind"], dil=c["dil"], keep=keep)
        fn = lambda x, m, a, b, w, bias: sk.stage_plain(  # noqa: E731
            x, m, a, b, i["mask"], w, bias, **kw)
        leaves = (i["x"], i["m"], i["a"], i["b"], i["w"], i["bias"])
        cots = (i["go"], i["gs"])
        (o32, s32), g32 = plain_grads(fn, leaves, cots, torch.float32)
        (_, s64), g64 = plain_grads(fn, leaves, cots, torch.float64)
        main = c["lead"][0] == TRAIN_BATCH
        for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            tag = f"{case_label(c)}, {'fp32' if dt == torch.float32 else 'bf16'}"
            x, go = i["x"].to(dt), i["go"].to(dt)
            out, sums = sk.stage_forward(x, i["m"], i["a"], i["b"], i["mask"],
                                         i["w"], i["bias"], **kw)
            e = worst(f"stage fwd {tag}", [
                ("out", out, o32), ("sum vs float64", sums[0], s64[0]),
                ("sum of squares vs float64", sums[1], s64[1])], tol)
            if main and dt == torch.bfloat16:
                errs["stage_fwd"] = max(errs["stage_fwd"], e)
            same_bits(f"stage fwd {tag}", (out, sums), sk.stage_forward(
                x, i["m"], i["a"], i["b"], i["mask"], i["w"], i["bias"],
                **kw))

            def backward():
                gx, gmab, gw, gb = sk.stage_backward(
                    x, i["m"], i["a"], i["b"], i["mask"], i["w"], out, go,
                    i["gs"], has_bias=c["bias"], **kw)
                return [gx, *(gmab if c["pro"] else (None,) * 3), gw, gb]

            got = backward()
            same_bits(f"stage bwd {tag}", got, backward())
            # the prologue's gradients are the A and B sums: vs float64
            ref = [g32[0], *g64[1:4], *g32[4:]]
            e = worst(f"stage bwd {tag}", [
                (n + (" vs float64" if n[:2] == "g_" else ""), a, r)
                for n, a, r in zip(names, got, ref) if r is not None], tol)
            if main and dt == torch.bfloat16:
                errs["stage_bwd"] = max(errs["stage_bwd"], e)
    names = ("gh", "g_m_h", "g_a_h", "g_b_h", "gres", "g_m_r", "g_a_r",
             "g_b_r")
    for c in join_cases:
        i = join_inputs(c, gen, dev, keep)
        kw = dict(keep=keep, act_h=c["act_h"])
        fn = lambda h, mh, ah, bh, res, mr, ar, br: (sk.join_plain(  # noqa: E731
            h, mh, ah, bh, i["mask"], res, mr, ar, br, **kw),)
        main = c["lead"][0] == TRAIN_BATCH
        for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            tag = f"{case_label(c)}, {'fp32' if dt == torch.float32 else 'bf16'}"
            h, res, go = (i[k].to(dt) for k in ("h", "res", "go"))
            # the references: the plain version in fp32 and float64 on the
            # inputs the kernel is given (h, res and go as rounded to dt)
            leaves = (h, *i["vh"], res, *i["vr"])
            (o32,), g32 = plain_grads(fn, leaves, (go,), torch.float32)
            _, g64 = plain_grads(fn, leaves, (go,), torch.float64)
            out = sk.join_forward(h, *i["vh"], i["mask"], res, *i["vr"], **kw)
            e = worst(f"fwd {tag}", [("out", out, o32)], tol)
            if main and dt == torch.bfloat16:
                errs["join_fwd"] = max(errs["join_fwd"], e)

            def backward():
                gh, gres, gvec = sk.join_backward(
                    h, *i["vh"], i["mask"], res, *i["vr"], go, **kw)
                return [gh, *gvec[0], gres,
                        *(gvec[1] if c["res_norm"] else (None,) * 3)]

            got = backward()
            same_bits(f"join bwd {tag}", got, backward())
            if c is join_cases[0] and dt == torch.bfloat16:
                join_workspace_checks(sk, got, backward, join_cases, gen,
                                      dev, keep)
            ref = [g32[0], *g64[1:4], g32[4], *g64[5:]]
            if dt == torch.bfloat16:
                # gh and gres against the kernels' rounding points; the
                # fp32 plain version's distance logged beside it
                plain = [(n, a, r) for n, a, r in zip(names, got, ref)
                         if n in ("gh", "gres")]
                ref[0], ref[4] = sk.join_backward_rounded(
                    h, *i["vh"], i["mask"], res, *i["vr"], go, **kw)
                log(f"  bwd {tag}: against the fp32 plain version, whose "
                    f"forward rounds nothing, " + ", ".join(
                        f"{n} {err_ratio(a, r):.3f}" for n, a, r in plain)
                    + " of 2e-2 x max|ref| (not asserted)")
            e = worst(f"bwd {tag}", [
                (n + (" vs float64" if n[:2] == "g_" else ""), a, r)
                for n, a, r in zip(names, got, ref) if r is not None], tol)
            if main and dt == torch.bfloat16:
                errs["join_bwd"] = max(errs["join_bwd"], e)
    torch.cuda.synchronize()
    log("  every stage and join launch, run twice on the same inputs, gave "
        "the same bits")
    return errs


def err_ratio(got, ref, tol=TOL_BF16):
    """max|got - ref| over tol x max|ref|."""
    return ((got.double() - ref.double()).abs().max()
            / (tol * ref.double().abs().max())).item()


def join_backward_fn(sk, c, gen, dev, keep, dt=torch.bfloat16):
    """One ``join_backward`` call on seeded inputs of join ``c``."""
    i = join_inputs(c, gen, dev, keep)
    h, res, go = (i[k].to(dt) for k in ("h", "res", "go"))
    return lambda: list(sk.join_backward(h, *i["vh"], i["mask"], res,
                                         *i["vr"], go, keep=keep,
                                         act_h=c["act_h"]))


def join_workspace_checks(sk, first, backward, cases, gen, dev, keep):
    """The backward's workspace (partials and per-slice counters, one a
    stream and plan): the first case's backward on a second stream while
    the default stream runs it too, and two shapes that share a workspace
    (the conv joins of 8 channels on 240 and 120 positions: same C, grid
    and slices) back to back, each bit-equal to its first launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = backward()
    here = backward()
    torch.cuda.current_stream().wait_stream(side)
    same_bits("join bwd on a second stream", first, on_side)
    same_bits("join bwd beside a second stream", first, here)
    a, b = (next(c for c in cases if c["c"] == 8
                 and c["lead"] == (TRAIN_BATCH, 20, w)) for w in (240, 120))
    pa, pb = (sk.join_plan(math.prod(c["lead"]), 8, torch.bfloat16, True)
              for c in (a, b))
    if (pa.grid, pa.slices) != (pb.grid, pb.slices):
        raise AssertionError(f"the two conv joins do not share a workspace: "
                             f"{pa} vs {pb}")
    fa, fb = (join_backward_fn(sk, c, gen, dev, keep) for c in (a, b))
    ra, rb = fa(), fb()
    torch.cuda.synchronize()
    runs = [fa(), fb(), fa(), fb()]
    for k, got in enumerate(runs):
        same_bits(f"join bwd back to back through one workspace, launch {k}",
                  (ra, rb)[k % 2], got)
    torch.cuda.synchronize()
    log(f"  join bwd: on a second stream beside the default one, and two "
        f"shapes back to back through one workspace ({pa.grid} partial "
        f"rows, {pa.slices} slice), the same bits as alone")


def fused_slice(dev, all_kernels, xs, ys):
    """Phase 9.  Returns the fused bf16 train state and the launches of one
    fused train step."""
    from wiflow_tpu_torch.core.config import ModelConfig
    cfg = ModelConfig(**FUSED)
    log(f"phase 9: training through stage and join, ModelConfig({FUSED}) "
        f"({cfg.compute_dtype}, dropout {cfg.dropout}/{cfg.conv_dropout}), "
        f"batch {TRAIN_BATCH}, 2 epochs over {TRAIN_WINDOWS} windows")
    state, launches = run_training(
        dev, all_kernels, cfg, xs, ys,
        {**dict.fromkeys(TRAIN_KERNELS, 2), **STAGE_LAUNCHES})
    join_kernels_of_step(state, xs[:TRAIN_BATCH], ys[:TRAIN_BATCH])
    # One fp32 step with dropout on, from one seed (so both paths draw the
    # same masks), through the stock-op path and through the fused path.
    # The two do the same arithmetic in another order in 48 places, and the
    # step amplifies fp32 rounding (the activations of the two paths agree
    # to a few 1e-6 up to the attention, whose logits BatchNorm takes
    # E[x^2] - mean^2 in fp32): two fp32 runs of the step cannot be held to
    # 1e-4.  So the rounding noise of the step is measured, as the
    # difference between the stock-op step on the card and the same step in
    # torch's CPU ops (dropout at 0 there: a CPU generator draws other
    # masks), and the fused step is held to twice that.
    xb, yb = xs[:TRAIN_BATCH].float(), ys[:TRAIN_BATCH]
    kw = dict(compute_dtype="float32")
    off = ModelConfig(dropout=0.0, conv_dropout=0.0, **kw)
    card, host = fp32_step(dev, off, xb, yb), fp32_step("cpu", off, xb, yb)
    noise = max(leaf_noise(card[1], host[1], GRAD_FLOOR),
                leaf_noise(card[2], host[2], STAT_FLOOR),
                leaf_noise({"g": card[0]["grad_norm"]},
                           {"g": host[0]["grad_norm"]}, 0.0))
    tol = max(TOL_F32, 2.0 * noise)
    log(f"  fp32 rounding noise of one train step (stock ops on the card vs "
        f"stock ops on the CPU, dropout 0): largest relative difference of a "
        f"gradient leaf, a running statistic or the gradient norm "
        f"{noise:.3e}; the fused step is held to {tol:.3e}")
    compare_fp32_steps("fused vs stock ops, dropout on",
                       fp32_step(dev, ModelConfig(**kw, **FUSED), xb, yb),
                       fp32_step(dev, ModelConfig(**kw), xb, yb), tol)
    compare_fp32_steps("fused vs stock ops, dropout 0",
                       fp32_step(dev, ModelConfig(dropout=0.0,
                                                  conv_dropout=0.0, **kw,
                                                  **FUSED), xb, yb),
                       card, tol)
    return state, launches


def kernels_in_order(fn, runs: int = 3):
    """The device kernels of ``runs`` calls of ``fn()`` by name, in the
    order they started (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)]


def join_kernels_of_step(state, xb, yb, runs: int = 3):
    """A fused step's device kernels: 9 join launches each way, and no
    float64 reduction launched after a join backward (its last blocks sum
    the partials)."""
    from wiflow_tpu_torch.train.steps import train_step
    names = kernels_in_order(lambda: train_step(state, xb, yb), runs)
    fwd, bwd = ([i for i, n in enumerate(names) if w in n]
                for w in ("join_forward_kernel", "join_backward_kernel"))
    after = [names[i + 1] for i in bwd if i + 1 < len(names)]
    reductions = sum("reduce_affine_grads" in n for n in names)
    log(f"  device kernels of {runs} fused steps (torch.profiler): join "
        f"forward {len(fwd)}, join backward {len(bwd)}, reduce_affine_grads "
        f"{reductions} (all after a stage backward), after a join backward: "
        + json.dumps(sorted({re.sub(r"<.*", "", n)[:40] for n in after})))
    if round(len(fwd) / runs) != 9 or round(len(bwd) / runs) != 9:
        raise AssertionError(f"{len(fwd)} / {len(bwd)} join launches in "
                             f"{runs} fused steps, expected 9 a step each")
    if any("reduce_affine_grads" in n for n in after):
        raise AssertionError("a reduce_affine_grads launch followed a join "
                             "backward")


def stage_work(c, esize):
    """(FLOPs, bytes) of one stage launch, forward and backward: each
    multiply-add of the true grouped conv counts 2 (the input gradient and
    the weight gradient as many again), each input byte is read once and
    each output written once."""
    ktaps = 1 if c["kind"] in ("identity", "chunk1") else 3
    win = c["lead"][-1]
    wout = (win - 1) // 2 + 1 if c["kind"].startswith("chunk") else win
    rows = math.prod(c["lead"][:-1])
    nw = c["co"] * (c["ci"] // c["groups"]) * ktaps
    xb, ob = rows * win * c["ci"] * esize, rows * wout * c["co"] * esize
    mask = {None: 0, "element": rows * win * c["ci"],
            "sample": c["lead"][0] * c["ci"]}[c["mask"]]
    vecs = 4 * (3 * c["ci"] * c["pro"] + c["co"] * c["bias"])
    conv = 2 * rows * wout * nw
    fwd = (conv, xb + ob + 4 * nw + mask + vecs + 8 * c["co"])
    bwd = (conv * (2 if c["need_gx"] else 1),
           xb + 2 * ob + (xb if c["need_gx"] else 0) + 8 * nw + mask
           + 2 * vecs + 8 * c["co"])
    return fwd, bwd


def join_work(c, esize):
    """(FLOPs, bytes) of one join launch, forward and backward."""
    n = math.prod(c["lead"]) * c["c"]
    mask = n if c["mask"] else 0
    vecs = 4 * 3 * c["c"] * (2 if c["res_norm"] else 1)
    return ((20 * n, 3 * n * esize + mask + vecs),
            (40 * n, 5 * n * esize + mask + 2 * vecs))


def fused_timings(dev, cfg, stock_state, fused_state, xb, yb, launches, errs):
    """Phase 10: ``stage`` and ``join`` over the launches of one step and
    per geometry, then the fused step against the stock-op step."""
    record = stage_kernel_timings(dev, cfg, launches, errs)
    fused_step_timings(stock_state, fused_state, xb, yb, record)
    return record


def stage_kernel_timings(dev, cfg, launches, errs):
    """The kernel half of phase 10.  Returns the record rows of ``stage``
    and ``join``, forward and backward."""
    import torch.nn.functional as F
    from wiflow_tpu_torch.ops.kernels import stage_fused as sk
    log(f"phase 10: stage and join timings, bf16, batch {TRAIN_BATCH} (CUDA "
        f"events, median of {RUNS})")
    keep = 1.0 - cfg.dropout
    dt = torch.bfloat16
    stages, joins = sk.step_launches(cfg, TRAIN_BATCH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def paths(c):
        """The plan's path of the forward, the input gradient (none when
        the input needs no gradient) and the weight gradient."""
        plan = sk.stage_plan(sk.stage_geometry(
            c["kind"], c["lead"], c["ci"], c["co"], c["groups"], c["dil"]), dt)
        return (plan.fwd.path, plan.dgrad.path if c["need_gx"] else "none",
                plan.wgrad.path)

    def stage_fns(c):
        i = stage_inputs(c, gen, dev, keep)
        x, go = i["x"].to(dt), i["go"].to(dt)
        args = (i["m"], i["a"], i["b"], i["mask"], i["w"], i["bias"])
        kw = dict(kind=c["kind"], dil=c["dil"], keep=keep)
        out, _ = sk.stage_forward(x, *args, **kw)
        leaves = [t.detach().clone().requires_grad_(True) for t in
                  (x, i["m"], i["a"], i["b"], i["w"], i["bias"])
                  if t is not None]
        it = iter(leaves)
        pl = [None if t is None else next(it) for t in
              (x, i["m"], i["a"], i["b"])] + [i["mask"]] + [
            None if t is None else next(it) for t in (i["w"], i["bias"])]
        pout = sk.stage_plain(*pl, **kw)
        lib = None
        if not c["pro"] and c["mask"] is None:
            # the stage is a bare convolution: one F.conv call on the
            # channel-first view of the same tensor
            ktaps = i["w"].shape[-1]
            stride = 2 if c["kind"].startswith("chunk") else 1
            w16 = i["w"].to(dt)
            b16 = None if i["bias"] is None else i["bias"].to(dt)
            if len(c["lead"]) == 2:
                xc = F.pad(x.transpose(1, 2), (2 * c["dil"], 0)) if (
                    c["kind"] == "causal3") else x.transpose(1, 2)
                lib = lambda: F.conv1d(  # noqa: E731
                    xc, w16, b16, dilation=c["dil"], groups=c["groups"])
            else:
                xc = x.permute(0, 3, 1, 2)
                lib = lambda: F.conv2d(  # noqa: E731
                    xc, w16, b16, stride=(1, stride),
                    padding=(0, ktaps // 2))
        return dict(
            fwd=lambda: sk.stage_forward(x, *args, **kw),
            bwd=lambda: sk.stage_backward(
                x, *args[:5], out, go, i["gs"], has_bias=c["bias"],
                need_gx=c["need_gx"], **kw),
            plain_fwd=lambda: sk.stage_plain(*pl, **kw),
            plain_bwd=lambda: torch.autograd.grad(
                pout, leaves if c["need_gx"] else leaves[1:],
                (go, i["gs"]), retain_graph=True),
            lib=lib)

    def join_fns(c):
        i = join_inputs(c, gen, dev, keep)
        h, res, go = (i[k].to(dt) for k in ("h", "res", "go"))
        kw = dict(keep=keep, act_h=c["act_h"])
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (h, *i["vh"], res, *i["vr"]) if t is not None]
        it = iter(leaves)
        pl = [next(it) for _ in range(4)] + [i["mask"], next(it)] + [
            None if t is None else next(it) for t in i["vr"]]
        pout = sk.join_plain(*pl, **kw)
        return dict(
            fwd=lambda: sk.join_forward(h, *i["vh"], i["mask"], res,
                                        *i["vr"], **kw),
            bwd=lambda: sk.join_backward(h, *i["vh"], i["mask"], res,
                                         *i["vr"], go, **kw),
            plain_fwd=lambda: sk.join_plain(*pl, **kw),
            plain_bwd=lambda: torch.autograd.grad(pout, leaves, go,
                                                  retain_graph=True),
            lib=None)

    sfn = [stage_fns(c) for c in stages]
    jfn = [join_fns(c) for c in joins]
    swork = [stage_work(c, 2) for c in stages]
    jwork = [join_work(c, 2) for c in joins]
    plain_runs = max(3, RUNS // 4)

    # per geometry: each distinct launch of the step, once
    log("  per launch: kernel / plain / bound ms, forward then backward "
        "(CUDA events: a launch of a few microseconds reads as the host's "
        "time to enqueue it); F.conv where the stage is a bare convolution; "
        "the device's busy time in the kernels (torch.profiler); the plan's "
        "path of the forward, the input gradient and the weight gradient")
    seen = set()
    for c, f, (wf, wb) in list(zip(stages, sfn, swork)) + list(
            zip(joins, jfn, jwork)):
        label = case_label(c)
        if label in seen:
            continue
        seen.add(label)
        bf, byf = bound_ms(*wf, dt)
        bb, byb = bound_ms(*wb, dt)
        lib = ("" if f["lib"] is None
               else f", F.conv {time_ms(f['lib'], RUNS):.4f}")
        if "kind" in c:
            path = " [" + " / ".join(paths(c)) + "]"
        else:
            path = " [" + " / ".join(
                "v {0.vec}, {0.slices} x {0.cols} chunks, {0.rows} rows, "
                "grid {0.grid}".format(sk.join_plan(
                    math.prod(c["lead"]), c["c"], dt, bwd))
                for bwd in (False, True)) + "]"
        log(f"    {label}: fwd {time_ms(f['fwd'], RUNS):.4f} / "
            f"{time_ms(f['plain_fwd'], plain_runs):.4f} / {bf:.4f} ({byf})"
            f"{lib}; bwd {time_ms(f['bwd'], RUNS):.4f} / "
            f"{time_ms(f['plain_bwd'], plain_runs):.4f} / {bb:.4f} ({byb})"
            f"; device busy fwd {device_ms(f['fwd']):.4f}, bwd "
            f"{device_ms(f['bwd']):.4f}{path}")

    # summed over the launches of one train step
    record, join_busy = [], []
    for name, fns, work, key in (("stage_fwd", sfn, swork, "fwd"),
                                 ("stage_bwd", sfn, swork, "bwd"),
                                 ("join_fwd", jfn, jwork, "fwd"),
                                 ("join_bwd", jfn, jwork, "bwd")):
        # the host's time to enqueue the loop beside the device's time to
        # run it: which of the two paces the launches
        ms, enqueue_ms = time_step_ms(lambda: [f[key]() for f in fns], RUNS)
        by_kernel = {}
        busy_ms = device_ms(lambda: [f[key]() for f in fns],
                            by_kernel=by_kernel)
        plain_ms = time_ms(lambda: [f["plain_" + key]() for f in fns],
                           plain_runs)
        which = 0 if key == "fwd" else 1
        # a launch cannot overlap the next: the bound is the sum of bounds
        bounds = [bound_ms(*w[which], dt) for w in work]
        bms = sum(b for b, _ in bounds)
        by = max(("bytes", "operations"),
                 key=lambda k: sum(b for b, kk in bounds if kk == k))
        kern = getattr(sk, STAGE_ATTRS[name])
        row = {"name": name, "route": "cuda", "source": kern.source,
               "replaces": kern.replaces, "launches": launches[name],
               "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "enqueue_ms": enqueue_ms, "device_busy_ms": busy_ms}
        lib = ""
        if name.startswith("stage"):
            counts = {}
            for c in stages:
                fwd_path, *bwd_paths = paths(c)
                for pth in (fwd_path,) if key == "fwd" else bwd_paths:
                    counts[pth] = counts.get(pth, 0) + 1
            row["paths"] = counts
            lib = f"; paths {json.dumps(counts)}"
        if name == "stage_fwd":
            bare = [f for f in fns if f["lib"] is not None]
            row["library_ms"] = time_ms(lambda: [f["lib"]() for f in bare],
                                        RUNS)
            row["library_launches"] = len(bare)
            row["ms_of_library_launches"] = time_ms(
                lambda: [f["fwd"]() for f in bare], RUNS)
            row["library_device_busy_ms"] = device_ms(
                lambda: [f["lib"]() for f in bare])
            row["device_busy_ms_of_library_launches"] = device_ms(
                lambda: [f["fwd"]() for f in bare])
            lib += (f"; the {len(bare)} launches that are bare convolutions: "
                    f"kernel {row['ms_of_library_launches']:.4f} ms (device "
                    f"busy {row['device_busy_ms_of_library_launches']:.4f}), "
                    f"F.conv {row['library_ms']:.4f} ms (device busy "
                    f"{row['library_device_busy_ms']:.4f})")
        if name.startswith("join"):
            join_busy.append(busy_ms)
        log(f"  {name}, the {len(fns)} launches of one step: kernel "
            f"{ms:.4f} ms (the host enqueues the loop in {enqueue_ms:.4f} "
            f"ms; the device is busy {busy_ms:.4f} ms of it), plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"(mostly {by}; {sum(w[which][0] for w in work) / 1e9:.3f} "
            f"GFLOP, {sum(w[which][1] for w in work) / 1e9:.4f} GB){lib}")
        for kname, (kms, count) in sorted(by_kernel.items(),
                                          key=lambda r: -r[1][0]):
            short = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "",
                           kname).split("(")[0]
            log(f"    {kms:8.4f} ms x{count:g} {short[:80]}")
        record.append(row)
    SUMMARY.append(f"join fwd / bwd device busy over the step's 9 launches "
                   f"{join_busy[0]:.4f} / {join_busy[1]:.4f} ms")
    del sfn, jfn
    torch.cuda.empty_cache()
    join_host_times(dev)
    return record


def join_host_times(dev):
    """The host's time in one call of each ``join`` wrapper at the conv
    stack's widest join (8 channels on ``[256, 20, 240]``, bf16): its
    checks, plan and launch.  It uses only the wrappers' interfaces, so it
    times any tree's: ``python3 -c "import torch, chip_smoke as c;
    c.build_kernels(only=['join_fused']); c.join_host_times(
    torch.device('cuda'))"``."""
    from wiflow_tpu_torch.ops.kernels import stage_fused as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    c = dict(lead=(TRAIN_BATCH, 20, 240), c=8, mask=None, res_norm=True,
             act_h=False)
    i = join_inputs(c, gen, dev, 1.0)
    h, res, go = (i[k].to(torch.bfloat16) for k in ("h", "res", "go"))
    fwd = host_ms(lambda: sk.join_forward(h, *i["vh"], None, res, *i["vr"],
                                          act_h=False))
    bwd = host_ms(lambda: sk.join_backward(h, *i["vh"], None, res, *i["vr"],
                                           go, act_h=False))
    log(f"  join wrappers, host time a call ({case_label(c)}, bf16): "
        f"forward {fwd:.4f} ms, backward {bwd:.4f} ms")
    SUMMARY.append(f"join host a call fwd {fwd:.4f} bwd {bwd:.4f} ms")


def fused_step_timings(stock_state, fused_state, xb, yb, record):
    """The step half of phase 10: the fused step against the stock-op
    step, in turns as in phase 7."""
    from wiflow_tpu_torch.train.steps import train_step

    def fused_step():
        train_step(fused_state, xb, yb)

    def stock_step():
        train_step(stock_state, xb, yb)

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    turns = {"fused": [], "stock": []}
    for r in range(STEP_ROUNDS):
        for name in ("fused", "stock")[::1 if r % 2 == 0 else -1]:
            turns[name].append(time_step_ms(
                fused_step if name == "fused" else stock_step, RUNS // 2))
    fused_ms = statistics.median(t for t, _ in turns["fused"])
    stock_ms = statistics.median(t for t, _ in turns["stock"])
    wins = sum(f < k for (f, _), (k, _) in zip(turns["fused"],
                                                turns["stock"]))
    host_share = statistics.median(h / t for t, h in turns["fused"])
    kernels_ms = sum(r["ms"] for r in record)
    log(f"fused train step bf16 batch {TRAIN_BATCH} (forward, backward, "
        f"clip, AdamW), median of {STEP_ROUNDS} turns of {RUNS // 2} steps: "
        f"{fused_ms:.4f} ms = {TRAIN_BATCH / fused_ms * 1e3:.1f} windows/s; "
        f"the stock-op step: {stock_ms:.4f} ms = "
        f"{TRAIN_BATCH / stock_ms * 1e3:.1f} windows/s; the fused step "
        f"faster in {wins} of {STEP_ROUNDS} rounds; the host's time to "
        f"enqueue a fused step {host_share:.1%} of the step; stage and join "
        f"alone {kernels_ms:.4f} ms = {kernels_ms / fused_ms:.1%} of it; "
        f"peak device memory of the step {peak / 2**30:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB held before it")
    for name, ts in turns.items():
        log(f"  {name} per turn, step / enqueue ms: "
            + " ".join(f"{t:.4f}/{h:.4f}" for t, h in ts))
    profile_step(fused_step, fused_ms, what="fused step")


def stage_phases():
    """Phase 8 and the kernel half of phase 10 alone: what a change to the
    ``stage`` or ``join`` kernels needs before the whole script is worth
    its time.  ``python3 -c "import chip_smoke as c; c.stage_phases()"``."""
    from wiflow_tpu_torch.core.config import ModelConfig
    build_kernels(("stage_fused", "join_fused"))
    dev, cfg = torch.device("cuda"), ModelConfig()
    errs = check_stage_kernels(dev, cfg)
    return stage_kernel_timings(dev, cfg, dict.fromkeys(STAGE_ATTRS, 0), errs)


def reset_launches(all_kernels):
    for k in all_kernels.values():
        k.launches = 0


def read_launches(all_kernels):
    torch.cuda.synchronize()
    return {n: k.launches for n, k in all_kernels.items()}


def expect_launches(what, got, want):
    """``got`` must be ``want`` for the kernels it names and 0 for every
    other kernel."""
    full = {n: want.get(n, 0) for n in got}
    log(f"kernels launched by {what}: "
        f"{json.dumps({n: v for n, v in got.items() if v})}")
    if got != full:
        raise AssertionError(f"{what} launched {got}, expected {full}")


def check_serving_kernels(tag, tcn_in, packed32, packed16, mid=None):
    """The three serving kernels against their plain versions at the shapes
    ``tcn_in [B, T, C0]`` gives them, each fed the fp32 plain result of the
    stage before it (``mid``, in stock ops, between the TCN and the conv
    stack): fp32 with TF32 off, bf16 against the fp32 plain version, and 7
    samples (101 conv rows), which leave the last thread block of every
    launch part-filled.  Returns each kernel's largest bf16 error at the
    full batch and the fp32 inputs of the three stages."""
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k
    from wiflow_tpu_torch.ops.kernels import conv_stack as conv_k
    from wiflow_tpu_torch.ops.kernels import tcn_level as tcn_k
    bf = torch.bfloat16
    b, t = tcn_in.shape[:2]
    errs = {}
    h, e = tcn_in, 0.0
    for i, (l32, l16) in enumerate(zip(packed32.tcn, packed16.tcn)):
        ref = tcn_k.tcn_level_plain(h, l32)
        compare(f"{tag}tcn level {i} fp32", tcn_k.tcn_level(h, l32), ref,
                TOL_F32)
        e = max(e, compare(f"{tag}tcn level {i} bf16",
                           tcn_k.tcn_level(h.to(bf), l16), ref, TOL_BF16))
        compare(f"{tag}tcn level {i} fp32, 7 samples",
                tcn_k.tcn_level(h[:7].contiguous(), l32), ref[:7], TOL_F32)
        compare(f"{tag}tcn level {i} bf16, 7 samples",
                tcn_k.tcn_level(h[:7].to(bf), l16), ref[:7], TOL_BF16)
        h = ref
    errs["tcn_level"] = e
    if mid is not None:
        h = mid(h)
    rows = h.reshape(b * t, -1)
    ref = conv_k.conv_stack_plain(rows, packed32.conv)
    compare(f"{tag}conv stack fp32", conv_k.fused_conv_stack_eval(
        rows, packed32.conv), ref, TOL_F32)
    errs["conv_stack"] = compare(
        f"{tag}conv stack bf16", conv_k.fused_conv_stack_eval(
            rows.to(bf), packed16.conv), ref, TOL_BF16)
    compare(f"{tag}conv stack fp32, 101 rows", conv_k.fused_conv_stack_eval(
        rows[:101], packed32.conv), ref[:101], TOL_F32)
    compare(f"{tag}conv stack bf16, 101 rows", conv_k.fused_conv_stack_eval(
        rows[:101].to(bf), packed16.conv), ref[:101], TOL_BF16)
    a_in = ref.reshape(b, t, *ref.shape[1:]).permute(0, 3, 1, 2).contiguous()
    ref = attn_k.dual_axial_attention_fused_plain(a_in, packed32.attention)
    compare(f"{tag}attention fp32", attn_k.dual_axial_attention_eval(
        a_in, packed32.attention), ref, TOL_F32)
    errs["axial_attention"] = compare(
        f"{tag}attention bf16", attn_k.dual_axial_attention_eval(
            a_in.to(bf), packed16.attention), ref, TOL_BF16)
    compare(f"{tag}attention fp32, 7 samples",
            attn_k.dual_axial_attention_eval(a_in[:7], packed32.attention),
            ref[:7], TOL_F32)
    compare(f"{tag}attention bf16, 7 samples",
            attn_k.dual_axial_attention_eval(a_in[:7].to(bf),
                                             packed16.attention),
            ref[:7], TOL_BF16)
    torch.cuda.synchronize()
    return errs, (tcn_in, rows, a_in)


def random_serving_weights(cfg, gen, dev):
    """fp32 TCN levels and conv blocks at ``cfg``'s widths, as if BN-folded
    from a trained model, each bias N(0, 0.5^2).  TCN weights are N(0,
    1/fan-in); the conv stack's N(0, 2/fan-in), because its 15 stacked
    convs shrink the signal at 1/fan-in until the output hardly varies over
    rows (1.1e-2 x max|ref| at 20,000 rows, against 4.6e-2 at 2/fan-in)."""
    from wiflow_tpu_torch.ops.kernels import conv_stack as conv_k
    from wiflow_tpu_torch.ops.kernels import tcn_level as tcn_k

    def w(*shape, fan, gain=1.0):
        return torch.randn(shape, generator=gen, device=dev) * math.sqrt(
            gain / fan)

    def b(n):
        return 0.5 * torch.randn((n,), generator=gen, device=dev)

    g = cfg.tcn_groups
    levels, cin = [], getattr(cfg, "input_channels", cfg.num_subcarriers)
    for i, cout in enumerate(cfg.tcn_channels):
        gi, go = cin // g, cout // g
        ds = cin != cout
        levels.append(tcn_k.TcnLevelWeights(
            w(3, g, gi, gi, fan=3 * gi), b(cin), w(cin, cout, fan=cin),
            b(cout), w(3, g, go, go, fan=3 * go), b(cout),
            w(cout, cout, fan=cout), b(cout),
            w(cin, cout, fan=cin) if ds else None, b(cout) if ds else None,
            2 ** i))
        cin = cout
    blocks, ci = [], 1
    for k, co in enumerate((cfg.conv_channels[0],) + tuple(cfg.conv_channels)):
        blocks.append(conv_k.ConvBlockWeights(
            w(3, ci, co, fan=3 * ci, gain=2), b(co),
            w(3, co, co, fan=3 * co, gain=2), b(co),
            w(3, co, co, fan=3 * co, gain=2), b(co),
            w(ci, co, fan=ci, gain=2), b(co), stride=1 if k == 0 else 2))
        ci = co
    return levels, blocks


def random_axes(c, groups, gen, dev):
    """fp32 folded ``AxisWeights`` of both attention axes: ``wq`` N(0,
    1/C), so q, k and v of an N(0, 1) input are O(1); the logits' scale
    (1 + U(0, 1)) / sqrt(8), so their std over keys is 1-2 and the softmax
    neither flat nor one-hot; biases N(0, 0.5^2) and N(0, 1); the output
    scale U(0.5, 1.5)."""
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    axes = []
    for _ in range(2):
        sim = torch.stack([(1 + rand(groups)) / math.sqrt(8), randn(groups)])
        oaff = torch.stack([0.5 + rand(c), 0.5 * randn(c)])
        axes.append(attn_k.AxisWeights(randn(c, 3 * c) / math.sqrt(c),
                                       0.5 * randn(3 * c), sim, oaff))
    return tuple(axes)


def check_spread(name, ref):
    """The reference must vary over rows: its std over rows, averaged over
    the outputs, at least MIN_SPREAD of max|ref|."""
    flat = ref.float().reshape(ref.shape[0], -1)
    spread = flat.std(dim=0).mean().item()
    scale = flat.abs().max().item()
    log(f"  {name}: reference std over rows {spread:.4e} = "
        f"{spread / scale:.4e} x max|ref| (must be >= {MIN_SPREAD:g})")
    if not spread >= MIN_SPREAD * scale:
        raise AssertionError(f"{name}: the reference hardly varies over rows "
                             f"({spread} against max|ref| {scale})")


def check_random_serving_kernels(tag, cfg, dev, batch):
    """The TCN level and conv stack kernels on N(0, 1) inputs through
    ``random_serving_weights``: fp32 (TF32 off) and bf16 against the fp32
    plain version at ``batch`` samples and at 7, each reference checked
    for spread, and a second launch of each held to the first bit for
    bit."""
    from wiflow_tpu_torch.ops.kernels import conv_stack as conv_k
    from wiflow_tpu_torch.ops.kernels import tcn_level as tcn_k
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    levels, blocks = random_serving_weights(cfg, gen, dev)
    t = cfg.window_size

    def cast(weights, dt):
        return [v.to(dt) if isinstance(v, torch.Tensor) and v.ndim > 1
                else v for v in weights]

    cases = []
    for i, lv in enumerate(levels):
        x = torch.randn((batch, t, lv.p1w.shape[0]), generator=gen,
                        device=dev)
        packed = {dt: tcn_k.level_weights(tcn_k.TcnLevelWeights(
            *cast(lv[:-1], dt))) for dt in (torch.float32, bf)}
        cases.append((f"{tag}random tcn level {i}", x, tcn_k.tcn_level,
                      tcn_k.tcn_level_plain, packed))
    rows = torch.randn((batch * t, conv_width(cfg)), generator=gen,
                       device=dev)
    packed = {dt: conv_k.stack_weights(
        [conv_k.ConvBlockWeights(*cast(blk, dt)) for blk in blocks])
        for dt in (torch.float32, bf)}
    cases.append((f"{tag}random conv stack", rows,
                  conv_k.fused_conv_stack_eval, conv_k.conv_stack_plain,
                  packed))
    for name, x, kernel, plain, packed in cases:
        ref = plain(x, packed[torch.float32])
        check_spread(name, ref)
        n7 = 7 * (t if x.ndim == 2 else 1)
        for dt, tol in ((torch.float32, TOL_F32), (bf, TOL_BF16)):
            label = "fp32" if dt == torch.float32 else "bf16"
            xd = x.to(dt)
            got = kernel(xd, packed[dt])
            compare(f"{name} {label}", got, ref, tol)
            same_bits(f"{name} {label}", [got], [kernel(xd, packed[dt])])
            compare(f"{name} {label}, 7 samples",
                    kernel(xd[:n7].contiguous(), packed[dt]), ref[:n7], tol)
        del ref, got
    check_random_attention_kernels(tag, cfg, dev, batch, gen)
    torch.cuda.synchronize()


def check_random_attention_kernels(tag, cfg, dev, batch, gen):
    """Rows 3, 4 and 5 on N(0, 1) inputs through ``random_axes`` at
    ``cfg``'s attention shape: fp32 (TF32 off) and bf16 against the fp32 plain version at ``batch`` samples and
    at 7, the reference checked for spread, a second launch of each held
    to the first bit for bit, and the one-launch kernel to the v2 kernel
    bit for bit.  Row 4 is held on each axis's precomputed projection
    (rounded to the storage type before the kernel and the plain version
    alike), and in fp32 also on both axes against the reference."""
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k
    bf = torch.bfloat16
    h, w = cfg.num_keypoints, cfg.window_size
    c = cfg.conv_channels[-1]
    axes32 = random_axes(c, cfg.attention_groups, gen, dev)
    packed = {dt: tuple(attn_k.axis_weights(aw._replace(wq=aw.wq.to(dt)))
                        for aw in axes32) for dt in (torch.float32, bf)}
    x = torch.randn((batch, h, w, c), generator=gen, device=dev)
    ref = attn_k.dual_axial_attention_fused_plain(x, axes32)
    name = f"{tag}random attention [{batch}, {h}, {w}, {c}]"
    check_spread(name, ref)
    for dt, tol in ((torch.float32, TOL_F32), (bf, TOL_BF16)):
        label = "fp32" if dt == torch.float32 else "bf16"
        axes = packed[dt]
        for n, xd in ((batch, x.to(dt)), (7, x[:7].to(dt))):
            v2 = attn_k.dual_axial_attention_eval(xd, axes)
            compare(f"{name} v2 {label}, {n} samples", v2, ref[:n], tol)
            same_bits(f"{name} v2 {label}, {n} samples", [v2],
                      [attn_k.dual_axial_attention_eval(xd, axes)])
            dual = attn_k.dual_axial_attention_eval_fused(xd, axes)
            compare(f"{name} dual {label}, {n} samples", dual, ref[:n], tol)
            same_bits(f"{name} dual {label}, {n} samples", [dual],
                      [attn_k.dual_axial_attention_eval_fused(xd, axes)])
            if not torch.equal(dual, v2):
                raise AssertionError(f"{name} {label}, {n} samples: the "
                                     f"dual and the v2 kernel differ")
            log(f"  {name} {label}, {n} samples: dual == v2 bit for bit")
            x_ax = xd
            for aw, width in zip(axes, (True, False)):
                axis = "width" if width else "height"
                qkv = attn_k.project_qkv_v1(x_ax, aw)
                got = attn_k.axial_attention_v1(qkv, aw.sim, aw.oaff, width)
                compare(f"{name} v1 {axis} axis {label} vs fp32 plain on the "
                        f"same qkv, {n} samples", got,
                        attn_k.axial_attention_v1_plain(
                            qkv.float(), aw.sim, aw.oaff, width), tol)
                same_bits(f"{name} v1 {axis} axis {label}", [got],
                          [attn_k.axial_attention_v1(qkv, aw.sim, aw.oaff,
                                                     width)])
                x_ax = got
            if dt == torch.float32:
                compare(f"{name} v1 both axes fp32, {n} samples", x_ax,
                        ref[:n], tol)
            del v2, dual, qkv, got, x_ax
    del ref, x


def conv_width(cfg):
    """The conv stack's input width: the TCN's last width or, for MM-Fi,
    the projection's."""
    return getattr(cfg, "tcn_proj_channels", cfg.tcn_channels[-1])


def time_serving_kernels(tag, cfg, inputs, packed16):
    """``{kernel: (ms, plain ms, bound ms, bound by)}`` of the three serving
    kernels in bf16 at the shapes of ``inputs``, and the cuBLAS time of the
    TCN levels' pointwise products alone."""
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k
    from wiflow_tpu_torch.ops.kernels import conv_stack as conv_k
    from wiflow_tpu_torch.ops.kernels import tcn_level as tcn_k
    tin16, rows16, a16 = (t.to(torch.bfloat16) for t in inputs)
    b = tin16.shape[0]

    def tcn_plain_stack():
        y = tin16
        for lv in packed16.tcn:
            y = tcn_k.tcn_level_plain(y, lv)
        return y

    cases = {
        "tcn_level": (lambda: tcn_k.fused_tcn_eval(tin16, packed16.tcn),
                      tcn_plain_stack, tcn_work(cfg, b, 2)),
        "conv_stack": (lambda: conv_k.fused_conv_stack_eval(
            rows16, packed16.conv),
            lambda: conv_k.conv_stack_plain(rows16, packed16.conv),
            conv_work(cfg, rows16.shape[0], 2)),
        "axial_attention": (lambda: attn_k.dual_axial_attention_eval(
            a16, packed16.attention),
            lambda: attn_k.dual_axial_attention_fused_plain(
                a16, packed16.attention),
            attention_work(cfg, b, 2)),
    }
    out = {}
    for name, (kfn, pfn, (flops, nbytes)) in cases.items():
        ms = time_ms(kfn, RUNS)
        plain_ms = time_ms(pfn, max(3, RUNS // 4))
        bms, by = bound_ms(flops, nbytes, torch.bfloat16)
        log(f"  {tag}{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e9:.4f} GB), fp32 CUDA-core bound "
            f"{flops / PEAK_FLOPS[torch.float32] * 1e3:.4f} ms")
        out[name] = (ms, plain_ms, bms, by)
    # A yardstick of the tensor-core rate the TCN kernel reaches, not a
    # library time of its function: torch.matmul (cuBLAS) on the levels'
    # pointwise products and shortcuts alone, [B T, C_in] x [C_in, C_out].
    gen = torch.Generator(device=tin16.device).manual_seed(SEED + 31)
    mats = []
    for lv in packed16.tcn:
        cin, cout = lv.p1w.shape
        for k, wt in ((cin, lv.p1w), (cout, lv.p2w), (cin, lv.dw)):
            if wt is not None:
                mats.append((torch.randn((tin16.shape[0] * tin16.shape[1], k),
                                         generator=gen, device=tin16.device
                                         ).to(torch.bfloat16), wt))
    cublas_ms = time_ms(lambda: [torch.matmul(a, w) for a, w in mats], RUNS)
    flops = sum(2 * a.shape[0] * w.shape[0] * w.shape[1] for a, w in mats)
    log(f"  {tag}tcn_level's pointwise products alone through torch.matmul "
        f"(cuBLAS, {len(mats)} products, {flops / 1e9:.2f} GFLOP): "
        f"{cublas_ms:.4f} ms = {flops / cublas_ms / 1e9:.1f} TFLOP/s")
    del mats
    return out, cublas_ms


def check_attention_variants(all_kernels, a_in, packed32, packed16, x32,
                             ref_out):
    """Phase 11.  Returns the bf16 errors at batch 4096 and the launches of
    one ``fast_forward`` of the v1 and the one-launch dual kernel."""
    from wiflow_tpu_torch.models.fast import fast_forward
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k
    log(f"phase 11: the v1 and the one-launch dual attention kernels vs "
        f"plain versions, batch {a_in.shape[0]} and batch 7")
    bf = torch.bfloat16
    errs = {}
    for label, a in ((f"batch {a_in.shape[0]}", a_in), ("batch 7", a_in[:7])):
        main = a is a_in
        ref = attn_k.dual_axial_attention_fused_plain(a, packed32.attention)
        # row 5: one launch, against its plain version and the v2 kernel
        compare(f"dual fp32, {label}", attn_k.dual_axial_attention_eval_fused(
            a, packed32.attention), ref, TOL_F32)
        d16 = attn_k.dual_axial_attention_eval_fused(a.to(bf),
                                                     packed16.attention)
        e = compare(f"dual bf16, {label}", d16, ref, TOL_BF16)
        for what, got, v2 in (
                ("fp32", attn_k.dual_axial_attention_eval_fused(
                    a, packed32.attention),
                 attn_k.dual_axial_attention_eval(a, packed32.attention)),
                ("bf16", d16, attn_k.dual_axial_attention_eval(
                    a.to(bf), packed16.attention))):
            if not torch.equal(got, v2):
                raise AssertionError(f"dual {what}, {label}: the dual and "
                                     f"the v2 kernel differ")
            log(f"  dual {what} vs the v2 kernel, {label}: equal bit for "
                f"bit")
        if main:
            errs["axial_attention_dual"] = e
        # row 4: each axis on its precomputed qkv (rounded to the storage
        # type before the kernel and before the plain version alike), then
        # both axes with their projections against the fp32 reference
        e, x_ax32, x_ax16 = 0.0, a, a.to(bf)
        for aw32, aw16, width in zip(packed32.attention, packed16.attention,
                                     (True, False)):
            axis = "width" if width else "height"
            qkv32 = attn_k.project_qkv_v1(x_ax32, aw32)
            x_ax32 = attn_k.axial_attention_v1_plain(qkv32, aw32.sim,
                                                     aw32.oaff, width)
            compare(f"v1 {axis} axis fp32, {label}", attn_k.axial_attention_v1(
                qkv32, aw32.sim, aw32.oaff, width), x_ax32, TOL_F32)
            qkv16 = attn_k.project_qkv_v1(x_ax16, aw16)
            got = attn_k.axial_attention_v1(qkv16, aw16.sim, aw16.oaff, width)
            e = max(e, compare(
                f"v1 {axis} axis bf16 vs fp32 plain on the same qkv, {label}",
                got, attn_k.axial_attention_v1_plain(
                    qkv16.float(), aw16.sim, aw16.oaff, width), TOL_BF16))
            same_bits(f"v1 {axis} axis bf16, {label}", [got], [
                attn_k.axial_attention_v1(qkv16, aw16.sim, aw16.oaff, width)])
            x_ax16 = got
        compare(f"v1 both axes fp32, {label}",
                attn_k.dual_axial_attention_eval_v1(a, packed32.attention),
                ref, TOL_F32)
        e = max(e, compare(f"v1 both axes bf16, {label}", x_ax16, ref,
                           TOL_BF16))
        if main:
            errs["axial_attention_v1"] = e
        del ref, d16, x_ax32, x_ax16, qkv32, qkv16, got
    check_v1_rounds(a_in, packed32, packed16)
    launches = {}
    want = {"dual": {"axial_attention_dual": 1},
            "v1": {"axial_attention_v1": 2}}
    for impl, own in want.items():
        reset_launches(all_kernels)
        out16 = fast_forward(packed16, x32, attention_impl=impl)
        got = read_launches(all_kernels)
        expect_launches(f"fast_forward(attention_impl={impl!r})", got,
                        {"tcn_level": len(packed16.tcn), "conv_stack": 1,
                         **own})
        launches.update({n: got[n] for n in own})
        compare(f"fast_forward {impl} bf16 vs module fp32", out16, ref_out,
                TOL_BF16)
        compare(f"fast_forward {impl} fp32 vs module fp32",
                fast_forward(packed32, x32, attention_impl=impl), ref_out,
                TOL_F32)
        compare(f"fast_forward {impl} bf16, batch 7, vs module fp32",
                fast_forward(packed16, x32[:7], attention_impl=impl),
                ref_out[:7], TOL_BF16)
        compare(f"fast_forward {impl} fp32, batch 7, vs module fp32",
                fast_forward(packed32, x32[:7], attention_impl=impl),
                ref_out[:7], TOL_F32)
    torch.cuda.synchronize()
    return errs, launches


def check_v1_rounds(a_in, packed32, packed16):
    """Phase 11, the v1 kernel's persistent grid: each axis's ``v1_plan``
    at batch 4096 and 7, and the kernel at a batch whose tiles leave the
    grid's last round part-filled on both axes (some blocks walk one tile
    more than others), fp32 and bf16 against the plain version, a second
    launch bit-equal."""
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k
    from wiflow_tpu_torch.ops.kernels.build import sm_count
    _, h, w, c = a_in.shape
    g = packed16.attention[0].sim.shape[1]
    sms = sm_count(a_in.device.index or 0)
    for batch in (a_in.shape[0], 7, V1_ROUND_BATCH):
        for dt in (torch.bfloat16, torch.float32):
            plan = attn_k.v1_plan(batch, h, w, c, g, dt, sms)
            for axis, ap in zip(("width", "height"), plan):
                # more tiles than blocks, and not a multiple of them
                part = ap.tiles > ap.grid and ap.tiles % ap.grid > 0
                log(f"  v1_plan batch {batch} {str(dt)[6:]} {axis}: {ap}; "
                    f"last round part-filled: {part}")
                if batch == V1_ROUND_BATCH and not part:
                    raise AssertionError(f"batch {batch} fills the v1 grid's "
                                         f"last round on the {axis} axis")
    a = a_in[:V1_ROUND_BATCH]
    label = f"batch {V1_ROUND_BATCH}, last round part-filled"
    for packed, dt, tol in ((packed32, torch.float32, TOL_F32),
                            (packed16, torch.bfloat16, TOL_BF16)):
        x_ax = a.to(dt)
        for aw, width in zip(packed.attention, (True, False)):
            axis = "width" if width else "height"
            qkv = attn_k.project_qkv_v1(x_ax, aw)
            got = attn_k.axial_attention_v1(qkv, aw.sim, aw.oaff, width)
            compare(f"v1 {axis} axis {str(dt)[6:]} vs fp32 plain on the "
                    f"same qkv, {label}", got, attn_k.axial_attention_v1_plain(
                        qkv.float(), aw.sim, aw.oaff, width), tol)
            same_bits(f"v1 {axis} axis {str(dt)[6:]}, {label}", [got], [
                attn_k.axial_attention_v1(qkv, aw.sim, aw.oaff, width)])
            x_ax = got
    torch.cuda.synchronize()
    log("  v1: every second launch gave the same bits as the first")


def mmfi_slice(dev, all_kernels):
    """Phase 12.  Returns what phase 13 times: the config, the bf16 packed
    weights, the plain module in bf16, the input, the three kernels' fp32
    inputs, their bf16 errors and their launches in one
    ``fast_forward_mmfi``."""
    import warnings

    import torch.nn.functional as F
    from wiflow_tpu_torch.metrics import mmfi_metrics as mm
    from wiflow_tpu_torch.models.fast import fast_forward_mmfi, pack_fast_mmfi
    from wiflow_tpu_torch.models.torch_compat import load_state_dict
    from wiflow_tpu_torch.models.wiflow_mmfi import (
        MMFiModelConfig, WiFlowMMFiModel,
    )
    cfg16 = MMFiModelConfig()
    cfg32 = MMFiModelConfig(compute_dtype="float32")
    log(f"phase 12: MM-Fi serving, default MMFiModelConfig "
        f"({cfg16.compute_dtype}; TCN {cfg16.input_channels} -> "
        f"{list(cfg16.tcn_channels)}, groups {cfg16.tcn_groups}; projection "
        f"to {cfg16.tcn_proj_channels}), batch {BATCH}")
    ref_model = WiFlowMMFiModel(
        cfg32, device=dev, generator=torch.Generator().manual_seed(SEED + 11))
    nontrivial_stats(ref_model)
    sd = ref_model.state_dict()
    packed32 = pack_fast_mmfi(sd, cfg32, device=dev)
    packed16 = pack_fast_mmfi(sd, cfg16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    x = torch.randn((BATCH, cfg16.num_antennas, cfg16.num_subcarriers,
                     cfg16.window_size), generator=gen, device=dev)
    tcn_in = x.reshape(BATCH, cfg16.input_channels,
                       cfg16.window_size).transpose(1, 2).contiguous()
    wproj, bproj = packed32.proj
    errs, inputs = check_serving_kernels(
        "MM-Fi ", tcn_in, packed32, packed16,
        mid=lambda y: F.silu(F.linear(y, wproj, bproj)))
    check_random_serving_kernels("MM-Fi ", cfg16, dev, BATCH)

    reset_launches(all_kernels)
    out16 = fast_forward_mmfi(packed16, x)
    launches = read_launches(all_kernels)
    expect_launches("fast_forward_mmfi", launches,
                    {"tcn_level": 3, "conv_stack": 1, "axial_attention": 2})
    shape = (BATCH, cfg16.num_keypoints, cfg16.keypoint_dims)
    if out16.shape != shape or out16.dtype != torch.float32:
        raise AssertionError(f"fast_forward_mmfi gave {out16.shape} "
                             f"{out16.dtype}, expected {shape} float32")
    ref_out = ref_model(x)                     # plain-torch module, fp32
    compare("fast_forward_mmfi fp32 vs module fp32",
            fast_forward_mmfi(packed32, x), ref_out, TOL_F32)
    compare("fast_forward_mmfi bf16 vs module fp32", out16, ref_out, TOL_BF16)
    compare("fast_forward_mmfi fp32, batch 7, vs module fp32",
            fast_forward_mmfi(packed32, x[:7]), ref_out[:7], TOL_F32)
    compare("fast_forward_mmfi bf16, batch 7, vs module fp32",
            fast_forward_mmfi(packed16, x[:7]), ref_out[:7], TOL_BF16)
    model16 = load_state_dict(WiFlowMMFiModel(cfg16, device=dev), sd)
    compare("MM-Fi module bf16 vs module fp32", model16(x), ref_out, TOL_BF16)

    # the served batch scored against seeded targets, on the card and on
    # the CPU: 1e-4, the spread of fp32 sums in another order (a PCK
    # fraction moves by 1.4e-5 with each of the 69,632 keypoints that
    # crosses a threshold).  Seeded weights serve nearly the same pose for
    # every window, so a second pair (the targets and a noisy copy of
    # them) spreads the metrics over their range.
    target = 0.25 * torch.randn(shape, generator=gen, device=dev)
    noisy = target + 0.03 * torch.randn(shape, generator=gen, device=dev)
    thresholds = (0.1, 0.2, 0.3, 0.4, 0.5)
    metrics = {
        "root_relative_pck_fractions":
            lambda p, t: mm.root_relative_pck_fractions(p, t, thresholds),
        "root_aligned_mpjpe": mm.root_aligned_mpjpe,
        "similarity_transform": mm.similarity_transform,
        "pa_mpjpe": mm.pa_mpjpe}
    for what, pred in (("served batch", out16), ("noisy targets", noisy)):
        for name, fn in metrics.items():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    card = fn(pred, target)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            host = fn(pred.cpu(), target.cpu())
            diff = (card.cpu() - host).abs().max().item()
            log(f"  MM-Fi metric {name}, {what}: card vs CPU "
                f"max_abs_diff={diff:.3e} (limit 1e-4), value "
                f"{[round(v, 6) for v in card.flatten()[:5].tolist()]}, host "
                f"syncs while computing it on the card: {len(caught)}")
            if card.device != pred.device or not diff <= 1e-4:
                raise AssertionError(f"MM-Fi metric {name}, {what}: card and "
                                     f"CPU differ by {diff}")
        pck = mm.root_relative_pck(pred, target)
        log(f"  MM-Fi root-relative PCK, {what}: "
            f"{json.dumps({str(k): round(v, 6) for k, v in pck.items()})}")
    torch.cuda.synchronize()
    return dict(cfg=cfg16, packed16=packed16, model16=model16, x=x,
                inputs=inputs, errs=errs, launches=launches)


def variant_timings(cfg, a_in, packed16, x32, launches, errs, mmfi):
    """Phase 13.  Returns the record rows of the v1 and the dual kernel and
    the MM-Fi times of the three serving kernels."""
    import torch.nn.functional as F
    from wiflow_tpu_torch.models.fast import fast_forward, fast_forward_mmfi
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k
    log(f"phase 13: timings of the attention lowerings and of MM-Fi serving "
        f"(CUDA events, median of {RUNS}, bf16)")
    dt = torch.bfloat16
    a16 = a_in.to(dt)
    b, h, w, c = a16.shape
    g = cfg.attention_groups
    axes = packed16.attention
    plain_runs = max(3, RUNS // 4)

    # row 4: the kernel's two launches on precomputed projections
    qkvs, heads, proj_in, x_ax = [], [], [], a16
    for aw, width in zip(axes, (True, False)):
        proj_in.append((x_ax, aw))
        qkv = attn_k.project_qkv_v1(x_ax, aw)
        qkvs.append((qkv, aw, width))
        qr = qkv if width else qkv.transpose(1, 2)
        n, length = (b * h, w) if width else (b * w, h)
        q, k, v = (t.reshape(n, length, g, c // g).transpose(1, 2)
                   for t in qr.split(c, dim=-1))
        # q pre-scaled by s_g; the bias b_g is constant over j and leaves
        # the softmax as it is
        heads.append(((q.float() * aw.sim[0][None, :, None, None]).to(dt)
                      .contiguous(), k.contiguous(), v.contiguous()))
        x_ax = attn_k.axial_attention_v1(qkv, aw.sim, aw.oaff, width)
    pos = b * h * w
    v1_flops = sum(2 * 2 * pos * length * c for length in (w, h))
    v1_bytes = 2 * (pos * 4 * c * 2 + 4 * (2 * g + 2 * c))
    att_flops, att_bytes = attention_work(cfg, b, 2)
    dual_bytes = att_bytes - 2 * pos * c * 2      # no intermediate traffic
    cases = {
        "axial_attention_v1": (
            attn_k.KERNEL_V1,
            lambda: [attn_k.axial_attention_v1(q, aw.sim, aw.oaff, wd)
                     for q, aw, wd in qkvs],
            lambda: [attn_k.axial_attention_v1_plain(q, aw.sim, aw.oaff, wd)
                     for q, aw, wd in qkvs],
            lambda: [F.scaled_dot_product_attention(q, k, v, scale=1.0)
                     for q, k, v in heads],
            (v1_flops, v1_bytes)),
        "axial_attention_dual": (
            attn_k.KERNEL_DUAL,
            lambda: attn_k.dual_axial_attention_eval_fused(a16, axes),
            lambda: attn_k.dual_axial_attention_fused_plain(a16, axes),
            None, (att_flops, dual_bytes)),
    }
    record = []
    for name, (kern, kfn, pfn, lfn, (flops, nbytes)) in cases.items():
        ms = time_ms(kfn, RUNS)
        SUMMARY.append(f"{name} {ms:.4f} ms")
        plain_ms = time_ms(pfn, plain_runs)
        lib_ms = time_ms(lfn, RUNS) if lfn else None
        bms, by = bound_ms(flops, nbytes, dt)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"  {name} (both axes): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, scaled_dot_product_attention {lib}, bound {bms:.4f} ms "
            f"({by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e9:.4f} GB)")
        record.append({"name": name, "route": "cuda", "source": kern.source,
                       "replaces": kern.replaces, "launches": launches[name],
                       "max_abs_err": errs[name], "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "library_ms": lib_ms})
    proj_ms = time_ms(lambda: [attn_k.project_qkv_v1(xa, aw)
                               for xa, aw in proj_in], RUNS)
    lowerings = {
        "v2": lambda: attn_k.dual_axial_attention_eval(a16, axes),
        "dual": lambda: attn_k.dual_axial_attention_eval_fused(a16, axes),
        "v1": lambda: attn_k.dual_axial_attention_eval_v1(a16, axes)}
    att = {n: time_ms(f, RUNS) for n, f in lowerings.items()}
    log(f"  dual attention on [{b}, {h}, {w}, {c}], all launches and "
        f"products: " + ", ".join(f"{n} {t:.4f} ms" for n, t in att.items())
        + f" (v1's two projections through torch.addmm alone: {proj_ms:.4f} "
        f"ms)")

    # fast_forward under the three lowerings, in turns within this call
    impls = ("v2", "dual", "v1")
    turns = {n: [] for n in impls}
    for r in range(4):
        for n in impls[::1 if r % 2 == 0 else -1]:
            turns[n].append(time_ms(
                lambda: fast_forward(packed16, x32, attention_impl=n),
                RUNS // 2))
    SUMMARY.append("fast_forward in turns " + ", ".join(
        f"{n} {statistics.median(turns[n]):.4f}" for n in impls) + " ms")
    for n in impls:
        ms = statistics.median(turns[n])
        log(f"fast_forward bf16 batch {b}, attention_impl={n!r}: {ms:.4f} ms "
            f"= {b / ms * 1e3:.1f} windows/s (median of 4 turns of "
            f"{RUNS // 2}: " + " ".join(f"{t:.4f}" for t in turns[n]) + ")")

    # MM-Fi serving
    m = mmfi
    mb = m["x"].shape[0]
    mmfi_times, mmfi_cublas = time_serving_kernels(
        "MM-Fi ", m["cfg"], m["inputs"], m["packed16"])
    torch.cuda.reset_peak_memory_stats()
    ff_ms = time_ms(lambda: fast_forward_mmfi(m["packed16"], m["x"]), RUNS)
    peak = torch.cuda.max_memory_allocated()
    mod_ms = time_ms(lambda: m["model16"](m["x"]), plain_runs)
    kernels_ms = sum(t[0] for t in mmfi_times.values())
    SUMMARY.append(f"fast_forward_mmfi {ff_ms:.4f} ms")
    log(f"fast_forward_mmfi bf16 batch {mb}: {ff_ms:.4f} ms = "
        f"{mb / ff_ms * 1e3:.1f} frames/s; plain-torch module bf16: "
        f"{mod_ms:.4f} ms = {mb / mod_ms * 1e3:.1f} frames/s; the three "
        f"kernels alone {kernels_ms:.4f} ms, the rest (input cast, layout "
        f"copies, projection, head, launch gaps) {ff_ms - kernels_ms:.4f} ms; "
        f"peak device memory while serving {peak / 2**30:.2f} GiB")
    return record, mmfi_times, mmfi_cublas


def build_kernels(only=None):
    """Phase 1.  Returns nvidia-smi's line for the card, the three kernels
    of the default serving path and every kernel of the port, by name.
    ``only`` names the libraries to build and load, all of them if None."""
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as train_k
    from wiflow_tpu_torch.ops.kernels import build as kbuild
    from wiflow_tpu_torch.ops.kernels import conv_stack as conv_k
    from wiflow_tpu_torch.ops.kernels import stage_fused as stage_k
    from wiflow_tpu_torch.ops.kernels import tcn_level as tcn_k
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    kernels = {"tcn_level": tcn_k.KERNEL, "conv_stack": conv_k.KERNEL,
               "axial_attention": attn_k.KERNEL}
    all_kernels = {**kernels,
                   "axial_attention_v1": attn_k.KERNEL_V1,
                   "axial_attention_dual": attn_k.KERNEL_DUAL,
                   **{n: getattr(train_k, a) for n, a in KERNEL_ATTRS.items()},
                   **{n: getattr(stage_k, a) for n, a in STAGE_ATTRS.items()}}
    libraries = sorted({k.name for k in all_kernels.values()
                        if only is None or k.name in only})
    t0 = time.perf_counter()
    secs = kbuild.build(libraries)
    log(f"kernel build, {len(libraries)} libraries: "
        f"{time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for lib in libraries:
        path = kbuild.BUILD_DIR / f"{lib}.log"
        for fn, line in ptxas_report(path.read_text()):
            log(f"  ptxas {lib} {fn}: {line}")
    for lib in SASS_LIBRARIES:
        if lib in libraries:
            kinds = set()
            for fn, counts in sass_counts(kbuild.library_path(lib)):
                log(f"  sass {lib} {fn}: " + ", ".join(
                    f"{op} {n}" for op, n in counts.items()))
                # the kernels are templates on the storage type, whose
                # name (mangled or not) says bfloat16 or not
                bf16 = "bfloat16" in fn
                kinds.add("bf16" if bf16 else "fp32")
                if lib in SASS_CHECKED and counts["HMMA"] != (
                        SASS_CHECKED[lib] if bf16 else 0):
                    raise AssertionError(
                        f"{lib} {fn}: HMMA {counts['HMMA']}; the bf16 "
                        f"kernels must project on the tensor cores with "
                        f"{SASS_CHECKED[lib]}, the fp32 ones on CUDA cores")
            if lib in SASS_CHECKED and kinds != {"bf16", "fp32"}:
                raise AssertionError(
                    f"{lib}: cuobjdump listed kernels of {sorted(kinds)}, "
                    f"not a bf16 and an fp32 one, so the HMMA check tested "
                    f"nothing")
    for k in all_kernels.values():
        if k.name in libraries:
            k.load()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    return smi, kernels, all_kernels


@torch.no_grad()
def serving_phases(dev, kernels, all_kernels):
    """Phases 2-4 and 11-13: everything that serves.  Returns the record
    rows of the five eval kernels."""
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.eval.streaming import (
        make_stream_infer, sliding_windows,
    )
    from wiflow_tpu_torch.models.fast import decode, fast_forward, pack_fast
    from wiflow_tpu_torch.models.torch_compat import load_state_dict
    from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k

    cfg16 = ModelConfig()
    cfg32 = ModelConfig(compute_dtype="float32")
    gen = torch.Generator().manual_seed(SEED)
    ref_model = WiFlowPoseModel(cfg32, device=dev, generator=gen)
    nontrivial_stats(ref_model)
    sd = ref_model.state_dict()
    packed32 = pack_fast(sd, cfg32, device=dev)
    packed16 = pack_fast(sd, cfg16, device=dev)
    b, t = BATCH, cfg16.window_size
    dgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x32 = torch.randn((b, cfg16.num_subcarriers, t), generator=dgen,
                      device=dev)

    # -- phase 2: each kernel vs its plain version at main-path shapes ------
    log(f"phase 2: kernels vs plain versions, batch {b}")
    errs, inputs = check_serving_kernels(
        "", x32.transpose(1, 2).contiguous(), packed32, packed16)
    check_random_serving_kernels("", cfg16, dev, b)
    a_in = inputs[2]                                 # [B, 15, 20, 64]

    # -- phase 3: the slice end to end --------------------------------------
    log(f"phase 3: fast_forward at batch {b} (bf16) and streaming")
    reset_launches(all_kernels)
    out16 = fast_forward(packed16, x32)
    launches = read_launches(all_kernels)
    expect_launches("fast_forward", launches,
                    {"tcn_level": len(packed16.tcn), "conv_stack": 1,
                     "axial_attention": 2})
    if out16.shape != (b, 15, 2) or out16.dtype != torch.float32:
        raise AssertionError(f"fast_forward gave {out16.shape} "
                             f"{out16.dtype}")
    ref_out = ref_model(x32)                    # plain-torch module, fp32
    compare("fast_forward fp32 vs module fp32",
            fast_forward(packed32, x32), ref_out, TOL_F32)
    compare("fast_forward bf16 vs module fp32", out16, ref_out, TOL_BF16)
    # batch 7 leaves the last thread block of the TCN and of the width
    # attention part-filled
    compare("fast_forward fp32, batch 7, vs module fp32",
            fast_forward(packed32, x32[:7]), ref_out[:7], TOL_F32)
    compare("fast_forward bf16, batch 7, vs module fp32",
            fast_forward(packed16, x32[:7]), ref_out[:7], TOL_BF16)
    model16 = load_state_dict(WiFlowPoseModel(cfg16, device=dev), sd)
    compare("module bf16 vs module fp32", model16(x32), ref_out, TOL_BF16)

    sgen = torch.Generator(device=dev).manual_seed(SEED + 2)
    stream = torch.randn((b + t - 1, cfg16.num_subcarriers),
                         generator=sgen, device=dev)
    infer = make_stream_infer(lambda w: fast_forward(packed16, w),
                              device=dev)
    reset_launches(all_kernels)
    poses = infer(stream)
    stream_launches = read_launches(all_kernels)
    log(f"kernels launched by the stream: "
        f"{json.dumps({n: stream_launches[n] for n in kernels})}")
    if not all(stream_launches[n] for n in kernels):
        raise AssertionError(f"a kernel did not run: {stream_launches}")
    direct = fast_forward(packed16, sliding_windows(stream, t))
    compare("stream vs fast_forward on the same windows", poses, direct,
            TOL_F32)
    stream_ms = time_ms(lambda: infer(stream), RUNS)
    log(f"stream of {stream.shape[0]} frames ({b} windows, bf16): "
        f"{stream_ms:.4f} ms = {b / stream_ms * 1e3:.1f} windows/s "
        f"(CUDA events, median of {RUNS})")

    # -- phase 4: timings ---------------------------------------------------
    log(f"phase 4: timings (CUDA events, median of {RUNS})")
    times, cublas_ms = time_serving_kernels("", cfg16, inputs, packed16)
    a16 = a_in.to(torch.bfloat16)
    dec_in = attn_k.dual_axial_attention_eval(a16, packed16.attention)
    dec_ms = time_ms(lambda: decode(packed16, dec_in), RUNS)
    log(f"  decoder (3x3 and 1x1 conv in torch, mean): {dec_ms:.4f} ms")
    ff_ms = time_ms(lambda: fast_forward(packed16, x32), RUNS)
    mod_ms = time_ms(lambda: model16(x32), max(3, RUNS // 4))
    SUMMARY.append(f"fast_forward {ff_ms:.4f} ms")
    log(f"fast_forward bf16 batch {b}: {ff_ms:.4f} ms = "
        f"{b / ff_ms * 1e3:.1f} windows/s; plain-torch module bf16: "
        f"{mod_ms:.4f} ms = {b / mod_ms * 1e3:.1f} windows/s")
    rest = ff_ms - dec_ms - sum(t[0] for t in times.values())
    log(f"  fast_forward less kernels and decoder (input cast, layout "
        f"copies, launch gaps): {rest:.4f} ms")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del dec_in, a16, stream, poses, direct, model16, inputs

    # -- phases 11-13: the other lowerings of fast_forward, and MM-Fi -------
    v_errs, v_launches = check_attention_variants(
        all_kernels, a_in, packed32, packed16, x32, ref_out)
    mmfi = mmfi_slice(dev, all_kernels)
    v_record, mmfi_times, mmfi_cublas = variant_timings(
        cfg16, a_in, packed16, x32, v_launches, v_errs, mmfi)

    record = []
    for name, (ms, plain_ms, bms, by) in times.items():
        m_ms, m_plain, m_bound, m_by = mmfi_times[name]
        record.append({"name": name, "route": "cuda",
                       "source": kernels[name].source,
                       "replaces": kernels[name].replaces,
                       "launches": launches[name],
                       "max_abs_err": errs[name], "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "library_ms": None,
                       "mmfi_launches": mmfi["launches"][name],
                       "mmfi_max_abs_err": mmfi["errs"][name],
                       "mmfi_ms": m_ms, "mmfi_plain_ms": m_plain,
                       "mmfi_bound_ms": m_bound, "mmfi_bound_by": m_by})
    record[list(times).index("tcn_level")].update(
        cublas_products_ms=cublas_ms,
        mmfi_cublas_products_ms=mmfi_cublas)
    return record + v_record, cfg16


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def cli_main(argv):
    """``wiflow_tpu_torch.cli.run.main(argv)`` in this process: must return
    0; returns what it printed."""
    from wiflow_tpu_torch.cli import run as cli
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli.run.main({argv}) returned {rc}")
    return tee.kept.getvalue()


@contextlib.contextmanager
def watched_steps(all_kernels):
    """Wraps ``train/steps.py::train_step`` for one run: the first step's
    launches are read (each train kernel must launch twice), the second
    runs with host syncs forbidden and must augment.  Yields the count of
    steps taken."""
    from wiflow_tpu_torch.train import steps
    inner = steps.train_step
    seen = {"steps": 0}

    def step(*args, **kw):
        i = seen["steps"]
        seen["steps"] += 1
        if i == 0:
            before = read_launches(all_kernels)
            m = inner(*args, **kw)
            after = read_launches(all_kernels)
            expect_launches("the resumed run's first step",
                            {n: after[n] - before[n] for n in after},
                            dict.fromkeys(TRAIN_KERNELS, 2))
            return m
        if i == 1:
            if kw.get("augment") is None:
                raise AssertionError("the resumed epoch's step does not "
                                     "augment")
            torch.cuda.set_sync_debug_mode("error")
            try:
                m = inner(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            log("  one augmented train step of the resumed run ran with no "
                "host sync (torch.cuda.set_sync_debug_mode('error'))")
            return m
        return inner(*args, **kw)

    steps.train_step = step
    try:
        yield seen
    finally:
        steps.train_step = inner


def csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def run_timings(text):
    """The ``[timings]`` line a CLI run printed."""
    lines = [ln for ln in text.splitlines() if ln.startswith("[timings] ")]
    if len(lines) != 1:
        raise AssertionError(f"{len(lines)} [timings] lines in the output")
    return json.loads(lines[0][len("[timings] "):])


def run_distance(a, b):
    """The largest relative difference between two runs' output
    directories: each history value, and each tensor of the final weights
    in the bundle, relative to its largest entry."""
    from wiflow_tpu_torch.core.checkpoint import load_checkpoint
    ha, hb = (load_checkpoint(os.path.join(d, "latest_checkpoint.pkl"))
              for d in (a, b))
    d = 0.0
    for key, va in ha["history"].items():
        ref = torch.tensor(hb["history"][key], dtype=torch.float64)
        got = torch.tensor(va, dtype=torch.float64)
        d = max(d, ((got - ref).abs().max()
                    / ref.abs().max().clamp(min=1e-30)).item())
    for key, va in ha["model"].items():
        ref, got = hb["model"][key].double(), va.double()
        if ref.numel():
            d = max(d, ((got - ref).abs().max()
                        / ref.abs().max().clamp(min=1e-30)).item())
    return d


def same_run(a, b):
    """Whether two runs' histories and final weights are equal bit for
    bit."""
    from wiflow_tpu_torch.core.checkpoint import load_checkpoint
    ha, hb = (load_checkpoint(os.path.join(d, "latest_checkpoint.pkl"))
              for d in (a, b))
    return ha["history"] == hb["history"] and sorted(ha["model"]) == \
        sorted(hb["model"]) and all(torch.equal(v, hb["model"][k])
                                    for k, v in ha["model"].items())


def epoch_numbers(what, timings, windows):
    """Logs one run's seconds per epoch, training windows/s, host share
    and write times."""
    rates = [windows / t for t in timings["train_s"]]
    share = [e / t for e, t in zip(timings["enqueue_s"], timings["train_s"])]
    log(f"  {what}: seconds per epoch "
        + ", ".join(f"{t:.3f}" for t in timings["epoch_s"])
        + "; training windows/s "
        + ", ".join(f"{r:.1f}" for r in rates)
        + "; the host's share of an epoch's training (its enqueue time) "
        + ", ".join(f"{100 * v:.1f}%" for v in share)
        + "; bundle writes " + ", ".join(f"{t:.4f}" for t in
                                          timings["bundle_s"])
        + " s; best-weight writes " + ", ".join(f"{t:.4f}" for t in
                                                timings["best_s"]) + " s")
    return rates, share


@torch.no_grad()
def serve_trained(dev, all_kernels, out, data_dir):
    """Phase 14, step 4: the best weights in ``out`` served through
    ``fast_forward`` and held to the plain module; returns the output's std
    over the batch and max|output|."""
    import numpy as np
    from wiflow_tpu_torch.core.checkpoint import load_best_model
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.data.dataset import CSIKeypointsDataset
    from wiflow_tpu_torch.data.splits import (
        expand_to_samples, file_level_split,
    )
    from wiflow_tpu_torch.models.fast import fast_forward, pack_fast
    from wiflow_tpu_torch.models.torch_compat import load_state_dict
    from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
    sd = load_best_model(os.path.join(out, "best_pose_model.pth"))
    from_msgpack = load_best_model(os.path.join(out,
                                                "best_pose_model.msgpack"))
    if not all(torch.equal(v, sd[k]) for k, v in from_msgpack.items()):
        raise AssertionError("best_pose_model.msgpack and .pth differ")
    log(f"  best_pose_model.msgpack gives the .pth's state_dict bit for bit "
        f"({len(from_msgpack)} tensors)")
    ds = CSIKeypointsDataset(data_dir)
    test_files = file_level_split(ds.num_files, seed=42)[2]
    x, _ = ds.materialize(expand_to_samples(ds.window_ranges, test_files))
    n = len(x)
    x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    x = x.repeat(-(-BATCH // n), 1, 1)[:BATCH]
    cfg = ModelConfig()
    packed = pack_fast(sd, cfg, device=dev)
    reset_launches(all_kernels)
    out16 = fast_forward(packed, x)
    expect_launches("fast_forward of the trained weights",
                    read_launches(all_kernels),
                    {"tcn_level": len(packed.tcn), "conv_stack": 1,
                     "axial_attention": 2})
    ref = load_state_dict(WiFlowPoseModel(ModelConfig(
        compute_dtype="float32"), device=dev), sd)(x)
    compare(f"trained weights: fast_forward bf16 vs module fp32, the test "
            f"split's {n} windows repeated to {BATCH}", out16, ref, TOL_BF16)
    spread = out16.std(dim=0).mean().item()
    top = out16.abs().max().item()
    log(f"  served output: std over the batch {spread:.4e} (mean over the "
        f"{out16[0].numel()} outputs), max|output| {top:.4e}, bar "
        f"{MIN_SPREAD * top:.4e} (1/100 of max|output|): "
        f"{'reached' if spread >= MIN_SPREAD * top else 'NOT reached'}")
    return spread, top


def cli_slice(dev, all_kernels):
    """Phase 14: train from the CLI, resume, and serve what it trained."""
    import importlib.util
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "preprocessed_csi_data")
        out, straight = os.path.join(tmp, "out"), os.path.join(tmp, "straight")
        flags = [*CLI_FLAGS, "--data_dir", data]
        cmd = [sys.executable, "-m", "wiflow_tpu_torch.cli.run", *flags,
               "--output_dir", out, "--epochs", "2"]
        log(f"phase 14: the CLI on the card: {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        first = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                               timeout=CLI_TIMEOUT)
        wall = time.perf_counter() - t0
        for line in first.stdout.splitlines():
            log(f"  | {line}")
        if first.returncode != 0:
            raise AssertionError(f"the CLI exited {first.returncode}:\n"
                                 f"{first.stderr[-4000:]}")
        missing = [f for f in CLI_FILES
                   if not os.path.exists(os.path.join(out, f))]
        png = os.path.exists(os.path.join(out, "training_history.png"))
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        if missing or png != has_mpl or (
                not has_mpl and "skipped training_history.png"
                not in first.stdout):
            raise AssertionError(f"the CLI's files: missing {missing}, PNG "
                                 f"{png} with matplotlib {has_mpl}")
        log(f"  the CLI exited 0 in {wall:.2f} s and wrote "
            + ", ".join(sorted(os.listdir(out))))
        first_hist = csv_rows(os.path.join(out, "training_history.csv"))
        first_t = run_timings(first.stdout)

        reset_launches(all_kernels)
        with watched_steps(all_kernels) as seen:
            text = cli_main([*flags, "--output_dir", out, "--epochs", "3"])
        launches = read_launches(all_kernels)
        steps = seen["steps"]
        expect_launches(f"the resumed run ({steps} steps)", launches,
                        {n: 2 * steps for n in TRAIN_KERNELS})
        if "[resume] continuing from epoch 3 of 3" not in text or \
                "Epoch 3/3" not in text:
            raise AssertionError("the second call did not resume at epoch 3")
        hist = csv_rows(os.path.join(out, "training_history.csv"))
        if len(hist) != 4 or hist[:3] != first_hist:
            raise AssertionError("the resumed history does not keep the "
                                 "first run's rows")
        log("  resumed at epoch 3; history rows of epochs 1-2 equal the first "
            "run's")
        resumed_t = run_timings(text)

        straight_t = run_timings(cli_main([*flags, "--output_dir", straight,
                                           "--epochs", "3"]))
        if same_run(out, straight):
            log("  resumed run vs the run never stopped: history and final "
                "weights equal bit for bit")
            SUMMARY.append("resume bit-equal")
        else:
            again = os.path.join(tmp, "again")
            cli_main([*flags, "--output_dir", again, "--epochs", "3"])
            noise = run_distance(again, straight)
            got = run_distance(out, straight)
            log(f"  resumed run vs the run never stopped: NOT bit-equal; "
                f"largest relative difference {got:.3e}, limit {2 * noise:.3e}"
                f" (twice that of two runs never stopped, {noise:.3e})")
            SUMMARY.append(f"resume within noise {got:.3e} <= {2 * noise:.3e}")
            if not got <= 2 * noise:
                raise AssertionError(f"resume differs by {got} > 2 x {noise}")

        windows = steps * int(CLI_FLAGS[CLI_FLAGS.index("--batch_size") + 1])
        epoch_numbers("first run (subprocess)", first_t, windows)
        epoch_numbers("resumed run", resumed_t, windows)
        summary_t = straight_t
        rates, share = epoch_numbers("run never stopped", straight_t,
                                     windows)
        log(f"  first run's wall clock (process start, synthetic data, 2 "
            f"epochs, artifacts): {wall:.2f} s")
        spread, top = serve_trained(dev, all_kernels, out, data)
        epochs = 3
        if spread < MIN_SPREAD * top:
            log(f"  3 epochs do not reach the spread bar: the resumed run "
                f"goes on to {SERVE_EPOCHS} epochs and its best weights are "
                f"served again")
            more_t = run_timings(cli_main([*flags, "--output_dir", out,
                                           "--epochs", str(SERVE_EPOCHS)]))
            rates, share = epoch_numbers(f"epochs 4-{SERVE_EPOCHS}",
                                         more_t, windows)
            summary_t, epochs = more_t, SERVE_EPOCHS
            spread, top = serve_trained(dev, all_kernels, out, data)
        if not spread >= MIN_SPREAD * top:
            raise AssertionError(f"the served output hardly varies: std "
                                 f"{spread} < {MIN_SPREAD} x {top}")
        SUMMARY.append(
            f"CLI first run {wall:.2f} s, epoch median "
            f"{statistics.median(summary_t['epoch_s']):.3f} s, "
            f"{statistics.median(rates):.1f} windows/s, host "
            f"{100 * statistics.median(share):.1f}%, served std after "
            f"{epochs} epochs {spread:.3e} of max {top:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi, kernels, all_kernels = build_kernels()
    dev = torch.device("cuda")

    # -- phases 2-4 and 11-13: the serving paths -----------------------------
    record, cfg16 = serving_phases(dev, kernels, all_kernels)
    torch.cuda.empty_cache()

    # -- phases 5-7: the training path ---------------------------------------
    c, g = cfg16.conv_channels[-1], cfg16.attention_groups
    main16, train_errs = check_train_kernels(dev, c, g)
    state, xs, ys, train_launches = train_slice(dev, all_kernels)
    xb, yb = xs[:TRAIN_BATCH], ys[:TRAIN_BATCH]
    record += train_timings(state, xb, yb, main16, c, g, train_launches,
                            train_errs)

    # -- phases 8-10: the stage-fused training path --------------------------
    stage_errs = check_stage_kernels(dev, cfg16)
    fused_state, fused_launches = fused_slice(dev, all_kernels, xs, ys)
    record += fused_timings(dev, cfg16, state, fused_state, xb, yb,
                            fused_launches, stage_errs)
    del state, fused_state, xs, ys, xb, yb
    torch.cuda.empty_cache()

    # -- phase 14: the CLI, resume, and the trained weights served ----------
    cli_slice(dev, all_kernels)

    log(smi)
    log(json.dumps({"kernels": record}))
    log("summary: " + "; ".join(SUMMARY))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
