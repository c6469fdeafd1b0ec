#!/usr/bin/env python3
"""Drive the port's serving and training paths on one NVIDIA GPU and check
their kernels.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits nonzero; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of the ten CUDA libraries from ``wiflow_tpu_torch/csrc``
   (one nvcc each, started together), with ptxas's registers and spills
   under each kernel's name, and the tensor-core instructions (``HMMA``,
   ``HGMMA``) that ``cuobjdump -sass`` finds in each kernel of
   ``conv_stack``, ``tcn_level``, ``stage_fused``, ``axial_attention``,
   ``axial_attention_dual``, ``axial_attention_v1``, ``axial_core``,
   ``logits_sums`` and ``channel_attention``: ``axial_attention``, ``axial_attention_dual``,
   ``axial_attention_v1`` and ``logits_sums`` must list a bf16 and an fp32
   kernel, the bf16 ones with 126, 252, 0 and 0 ``HMMA`` (one projection on
   the tensor cores, two, none, none), the fp32 ones with none;
   ``tcn_level``'s bf16 kernels (one a wgmma width) and ``conv_stack``'s
   bf16 kernel must hold ``HGMMA``, their fp32 kernels none;
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
   the first, over 4 at 7 sequences), at the MM-Fi model's at that batch,
   the MM-Fi CLI's (n=1088, L=10; n=640, L=17), and at 7 sequences of
   each length, which leave the last tile part-filled: fp32 with TF32
   off, the ``[2, G]`` sums and ``dscale`` also against float64, and bf16
   against the fp32 plain version; a second launch of each kernel must
   repeat the
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
   device's time with its calls queued behind a spin kernel) against its
   plain version, its bound and
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
   host's time to enqueue it and the device's time with it queued behind
   a spin kernel, which say whether the host or the card paces it;
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
   run's wall clock are printed;
15. MM-Fi training on the card, in a temporary directory: (a) the port's
   ``generate_synthetic_mmfi`` writes a learnable tree of 8 subjects x 2
   actions x 297 frames (4,752 frames, ``.npy``; the CLI's default split
   gives 2,673 train, 1,039 val and 1,040 test frames); (b) ``python -m
   wiflow_tpu_torch.cli.run_mmfi --dataset_root <tree> --epochs 2
   --batch_size 64 --lr 3e-3 --no_videos`` as a subprocess must exit 0
   and write the best weights, the resume bundle, both ``.npz`` caches
   and the CSVs;
   ``cli.run_mmfi.main`` with ``--epochs 3`` in this process must resume
   at epoch 3, keep the first two history rows exactly, launch each train
   kernel twice a step and take its second step with host syncs
   forbidden; a run of 3 epochs never stopped must equal it bit for bit
   (or within twice the distance of two runs never stopped, as in phase
   14); ``--synthetic`` on a missing root (the ``.mat`` tree) must train
   for 1 epoch and exit 0; (c) the trained ``.pth`` served by
   ``fast_forward_mmfi`` in bf16 at batch 4096 (the test split's frames,
   repeated) must hold the plain fp32 ``WiFlowMMFiModel`` at ``TOL_BF16``
   with an output std over the batch of at least 1/100 of max|output|
   (which the CLI's default lr does not reach: hence ``MMFI_LR``), its
   root-relative metrics on the card must match the same on the CPU, and
   the ``.msgpack`` must
   give the ``.pth``'s ``state_dict`` bit for bit; (d) the fused MM-Fi
   step (``MMFiModelConfig`` with both switches ``"fused"``, bf16, dropout
   on, batch 64) must launch ``stage`` and ``join`` each way as often as
   ``step_launches`` says (34 and 8) and each attention train kernel
   twice, and run a second step with no host sync; one fp32 step with
   dropout on through the fused path is held to the stock-op step at
   twice the step's fp32 noise, as in phase 9; every ``stage`` and
   ``join`` launch of the step is held to its plain version as in phase
   8; one ``train_pose_model`` epoch of the fused model on the tree; (e)
   timings: the CLI's seconds per epoch, training frames/s and host share;
   the stock-op and the fused MM-Fi step at batch 64 and 256 in
   alternating turns, each with the profiler's device busy time and
   events a step; rows 6-13 at the MM-Fi step's shapes at batch 64
   (CUDA events, the device's time queued behind a spin, launches and
   bound, into the ``mmfi_*`` keys of their record rows).

16. the ablations on the card, default ``ModelConfig`` at full width,
   bf16: (a) ``cli.ablation_demo.main`` (the argv of ``python -m
   wiflow_tpu_torch.cli.ablation_demo``) in this process over all five
   variants, ``--synth_mode multipath``, 4,096 windows, 2 epochs, batch
   256: it must write the summary and the table with the five rows in
   order, and launch each attention train kernel twice a step of every
   variant but ``no_attention`` and nothing else; each variant's
   parameters, epoch seconds and step ms are printed; (b) one bf16 train
   step of each variant: its launches (2 of each attention train kernel;
   none for ``no_attention``) and its parameters; (c) ``tcn_conv``
   ``plain`` and ``depthwise`` under both fused switches (rows 10-13):
   every new ``stage`` geometry (the TCN's k=3 convs in one group and in a
   group a channel, at batch 256 and 7) held to ``stage_plain`` in fp32
   (TF32 off) and bf16 as in phase 8, a second launch bit-equal, each
   geometry's ``stage_plan`` printed; a fused bf16 step must launch
   ``stage`` and ``join`` as often as ``step_launches`` says; one fused
   fp32 step with dropout on held to the stock-op step at 4x the step's
   fp32 noise: the stock-op step's distance to the same step in float64
   on the CPU (BatchNorm moments in float64 too, the card's dropout masks
   replayed there; the fused step's own distance, ~3x it, is printed);
   (d) timings: each new geometry's kernel,
   plain and bound ms forward and backward (CUDA events and queued behind
   a spin), and rows 10-13 over the launches of one fused step of each
   variant, into the ``tcn_plain_*`` / ``tcn_depthwise_*`` keys of their
   record rows;
17. the baselines on the card, each at its published widths, bf16: (a)
   ``cli.run_baseline`` ``--synthetic`` for ``hpeli``, ``wisppn``,
   ``perunet`` and ``wpformer``, batch 64, 1 epoch (the CLI's 20
   synthetic files cut to 100 frames: 1,134 train windows), in this
   process with
   its launches read (no kernel of the repository is on a baseline's
   path: every count must stay 0); each model's step ms, training
   windows/s, peak memory, parameters and FLOPs a window printed; ``hpeli``
   resumed to 2 epochs must equal a 2-epoch run never stopped, bit for
   bit; (b) ``cli.run_mmfi --model`` each baseline, 1 epoch, on phase 15's
   tree made again with 4 of its 8 subjects; (c) ``cli.baseline_table``
   over all five models at 2,048 windows, 1 epoch, batch 64: a FLOPs cell in every row, the
   attention train kernels launched twice a step of the ``wiflow`` row, and
   each row's step ms, windows/s, peak memory, parameters and FLOPs a
   window printed;
18. the robustness kit (HPE-Li's zoo, the stacked denoising AEs, the
   robustness CLIs): (a) the five zoo models and ``DenoiserHPE`` at 1 and
   5 stages on the card against the port on the CPU from the same weights
   (fp32, TF32 off, 1e-4), ``DenoiserHPE`` in bf16 against fp32 (2e-2);
   (b) ``MultiAxisAttention`` and its antialiased resize likewise; (c) the
   torch noise functions' statistics on the card; (d) each zoo model's and
   ``DenoiserHPE``'s train step at batch 32 (the CLI's) and 256: ms,
   windows/s, peak memory; (e) the AE's 5 greedy stages at MM-Fi's shape,
   1 epoch each, each frozen prefix unchanged bit for bit, each stage's
   epoch seconds; (f) ``cli.run_robustness`` in modes 0 (``original_hpe``),
   1 (``denoiser_hpe``, 2 stages) and 2 (Gaussian filter; its filter time
   on each split printed) on the CLI's learnable MM-Fi tree at 297 frames
   a sequence, ``dsknet_trans_wipose`` on synthetic WiPose, and
   ``cli.robustness_demo`` at one level for 2 epochs, each in this process
   with every launch count 0 (no kernel of the repository is on their
   paths); (g) ``evaluate_robustness`` over the flagship's
   ``fast_forward`` (bf16) serving the weights phase 14's CLI trained, on
   the CLI's test split against its true keypoints, at the kit's default
   AWGN levels 0.0, 0.1, 0.2 and 0.4 (no cleaner): level 0.0 must equal
   the same predictions evaluated directly, PCK@20 at 0.4 must be below
   PCK@20 at 0.0, and rows 1-3 must launch 4, 1 and 2 times a batch; the
   phase's wall clock;
19. the demo CLIs, cut in windows and epochs, never widths (bf16, batch
   256): ``cli.convergence_demo`` at 32,768 windows for 3 epochs in this
   process (the train kernels launched twice a step; its summary and
   windows/s printed), ``cli.kill_resume_demo`` at 8,192 windows for 4
   epochs (its runs subprocesses; killed after epoch 2's bundle, resumed
   at epoch 3, the histories within the JAX demo's tolerance, their
   largest difference printed), ``cli.loso_demo`` with 5 subjects x 2,048
   windows for 2 epochs (5 rows);
20. data parallelism at world size 1: ``train_pose_model`` for one epoch
   (stock ops, and fused) inside an NCCL process group of one rank
   (``parallel/mesh.py``) against the same epoch without it: history,
   test metrics, weights and predictions bit for bit, rows 6-9 (and
   10-13 fused) launched as often; ``cli.run --gpu`` one more than the
   cards must exit nonzero with "more ranks than devices";
21. WPformer served at its published widths (``WPformer()``, seeded, its
   BatchNorms spread), bf16, at the benchmark cell's batch of 512: the
   channel attention kernel (row 14) on the ``qkv [512, 2160, 2304]``
   that ``wpformer_forward``'s packed projection computes, and on random
   inputs at every C the plan takes, odd token counts and 1-4 heads,
   against ``channel_attention_plain``: max <= 2^-7 and RMS <= 1e-4 of
   max|plain|, a second launch bit-equal; two faults planted in the plain
   version (the InstanceNorm skipped, the last head left out) must read
   above both limits; the kernel and the served forward against the
   model's stock-op core (``core="stock"``) within 2e-2; ``wpformer_forward``
   must launch the kernel once; ``make_stream_infer`` over it, traced, on
   a 633-frame stream (614 windows: 2 batches, 410 rows of padding) must
   launch it twice and count 1,024 ``serve.channel_attention_windows``
   and ``stream.rows``; CUDA-event timings of the kernel, its plain
   version, the stock-op core and the forward on each core, the kernel's
   bound (1.70 GFLOP, 11.06 MB a window: bytes) and the core's share of a
   forward;
22. the conv stack kernel (row 2) on random weights and N(0, 1) rows at
   the shapes of ``CONV_SWEEP`` (the flagship at batch 1, 7, 4095 and
   4096, MM-Fi's chunks of 297-4096 windows, odd widths): bf16 and fp32
   against the fp32 plain version, a relaunch bit-equal, the count of
   convolutions on wgmma equal to the plan's; with ``--parent DIR`` (a
   checkout of the parent commit) fp32 equal to the parent's kernel bit
   for bit, and row 2 and the MM-Fi line timed beside the parent's in
   turns (parent, this, this, parent).  Alone: ``python3 -c "import
   torch, chip_smoke as c; c.build_kernels(('conv_stack',));
   c.conv_stack_slice(torch.device('cuda'), 'DIR')"``.

Phase 4 also holds the stock-op lowerings of ``fast_forward``
(``fuse_tcn=False``, ``fuse_conv_stack=False``, both) to the plain module
and to the default lowering, on the seeded weights and on weights whose
BatchNorms are spread so that the output varies, with their launches
(no TCN or no conv-stack kernel) and windows/s.

Phases 11-13 belong to serving and share its weights and inputs, so they
run after phase 4, before the training phases; phases 14-21 run last.
Phase 21 alone: ``python3 -c "import torch, chip_smoke as c; smi, k, a =
c.build_kernels(('channel_attention',)); c.wpformer_slice(
torch.device('cuda'), a)"``.
The last lines are the card's name and power limit, the kernels' JSON
record (14 rows; rows 1-3 and 6-13 also carry ``mmfi_*`` keys, rows 10-13
``tcn_plain_*`` and ``tcn_depthwise_*`` keys, row 14 ``stock_ms``,
``forward_ms`` and ``forward_stock_ms``), a summary
of the run (serving and step times, the steps' device busy time and the
train kernels' share of it, rows 6-9's queued and CUDA-event times,
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
                  "logits_sums", "channel_attention")
SASS_CHECKED = {"axial_attention": 126, "axial_attention_dual": 252,
                "axial_attention_v1": 0, "logits_sums": 0}
# Libraries whose bf16 kernels run their products on wgmma: each must hold
# HGMMA, the fp32 ones none (the TCN level: one bf16 kernel a wgmma width;
# the conv stack: one bf16 kernel, every width inside).
SASS_WGMMA = ("tcn_level", "conv_stack")
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


# Phase 15: the MM-Fi tree (subjects x actions, each a sequence of MM-Fi's
# 297 frames: cut from MM-Fi's 40 x 27 for the script's time), the MM-Fi
# CLI's flags, the files its first run must write, the lr of its runs (at
# the CLI's default, 1e-4, the best weights' eval-mode output hardly
# varies over the batch on this tree, under the served check's bar; at
# 3e-3 they pass it after the 3 epochs that the runs take), and the
# batches of the step timings.
MMFI_SUBJECTS = tuple(f"S{i:02d}" for i in range(1, 9))
MMFI_ACTIONS = ("A01", "A02")
MMFI_CLI_FLAGS = ["--batch_size", str(DEFAULT_BATCH), "--no_videos"]
MMFI_CLI_FILES = CLI_FILES + ("mmfi_train_cache.npz", "mmfi_val_cache.npz")
MMFI_LR = 3e-3
MMFI_STEP_BATCHES = (DEFAULT_BATCH, TRAIN_BATCH)
# Phase 16: the ablation CLI's data and recipe (the windows and epochs are
# cut to fit the script's time; the widths are the model's), and the TCN
# variants whose fused stages take new geometries.
ABLATION_WINDOWS = 4096
ABLATION_EPOCHS = 2
ABLATION_FLAGS = ["--windows", str(ABLATION_WINDOWS), "--epochs",
                  str(ABLATION_EPOCHS), "--batch_size", str(TRAIN_BATCH),
                  "--synth_mode", "multipath"]
TCN_VARIANTS = ("plain", "depthwise")
# Phase 17: the baselines at their published widths, batch 64, 1 epoch,
# on the CLI's synthetic files cut to 100 frames (1,134 train windows) and
# on phase 15's MM-Fi tree cut to 4 of its subjects (the comparison
# table at 2,048 windows): the script's time, widths untouched.
BASELINES = ("hpeli", "wisppn", "perunet", "wpformer")
BASELINE_FLAGS = ["--batch_size", str(DEFAULT_BATCH), "--epochs", "1"]
BASELINE_FRAMES = 100
BASELINE_MMFI_SUBJECTS = MMFI_SUBJECTS[:4]
TABLE_WINDOWS = 2048


# Phase 18: the robustness kit.  The zoo's models and DenoiserHPE (5
# stages, as the CLI builds it) stepped at the CLI's batch and at the
# train step's; the AE's 5 greedy stages on 2,048 random windows of
# MM-Fi's shape, 1 epoch each; the robustness CLI on its learnable tree
# at MM-Fi's 297 frames a sequence (4 subjects x 2 actions: 2,376
# frames), 2 epochs a run; the demo at one level, 2 epochs, on its own
# tree of 100 frames a sequence; the flagship's serving path, with the
# weights phase 14 trained, swept over the CLI's test split at batch 128.
# Cut for the script's time: windows,
# frames and epochs (the reference: MM-Fi's 40 x 27 sequences, 60
# epochs), never widths.
ROBUST_MODELS = ("original_hpe", "basic_cnn", "dsknet_trans", "hpe_wipose",
                 "dsknet_trans_wipose", "denoiser_hpe")
ROBUST_BATCHES = (32, TRAIN_BATCH)
ROBUST_STEPS = 10
AE_WINDOWS = 2048
ROBUST_CLI = ["--epochs", "2", "--synthetic", "--synthetic_learnable",
              "--synthetic_frames", "297", "--no_resume"]
SWEEP_BATCH = 128


# Phase 19: the demo CLIs, cut in windows and epochs (the reference:
# 360,000 windows and 50 epochs, LOSO 20,000 a subject for 12), never in
# widths; batch 256, the demos' default.
DEMO_WINDOWS = 32_768
DEMO_EPOCHS = 3
KILL_WINDOWS = 8_192
KILL_EPOCHS = 4
KILL_EPOCH = 2
LOSO_PER_SUBJECT = 2_048
LOSO_EPOCHS = 2


# Phase 21: WPformer's served path at the benchmark cell's batch.  The
# channel attention kernel against its plain version, as a share of
# max|plain|: max <= one bf16 step of the largest entry (2^-7: a P entry
# at a rounding edge rounds the other way when the scores sum in another
# order; 4.6e-3 on an H100), RMS <= 1e-4 (2.0e-5 at the published shape,
# 4.9e-5 on random inputs, on an H100).  The random inputs: (batch,
# tokens, C, heads).
WPFORMER_BATCH = 512
CA_TOL_MAX = 2.0 ** -7
CA_TOL_RMS = 1e-4
CA_SHAPES = ((3, 2160, 256, 3), (2, 37, 256, 3), (2, 100, 64, 2),
             (1, 33, 128, 4), (5, 1, 64, 1), (2, 2160, 256, 4))
CA_FAULT_BATCH = 64


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
    """(label, sequences, length, group) of the train kernels' launches:
    both axes of the ``[256, 15, 20, 64]`` attention input (group
    ``"main"``: the train step's), both of the MM-Fi model's ``[256, 17,
    10, 64]``, both of the flagship's at ``TrainConfig``'s default batch
    (``DEFAULT_BATCH``; the ``logits_sums`` kernels split the width axis's
    positions over 2 ranges), both of the MM-Fi model's at that batch
    (group ``"mmfi"``: the MM-Fi CLI's step, phase 15), then 7 sequences
    at each length, which leave the last tile part-filled (4 ranges)."""
    axes = []
    for model, (h, w) in (("", (15, 20)), ("MM-Fi ", (17, 10))):
        axes += [(f"{model}width", TRAIN_BATCH * h, w,
                  None if model else "main"),
                 (f"{model}height", TRAIN_BATCH * w, h,
                  None if model else "main")]
    for model, (h, w), group in (("", (15, 20), None),
                                 ("MM-Fi ", (17, 10), "mmfi")):
        axes += [(f"{model}width, batch {DEFAULT_BATCH}", DEFAULT_BATCH * h,
                  w, group),
                 (f"{model}height, batch {DEFAULT_BATCH}", DEFAULT_BATCH * w,
                  h, group)]
    return axes + [(f"L={length}, 7 seqs", 7, length, None)
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
    """Phase 5.  Returns, by the group of :func:`train_axes`, the bf16
    inputs of its two axes (for the timings of phases 7 and 15) and each
    kernel's largest bf16 error on them."""
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
    from wiflow_tpu_torch.ops.kernels.build import sm_count
    log(f"phase 5: train kernels vs plain versions, batch {TRAIN_BATCH} "
        f"shapes")
    from wiflow_tpu_torch.core.config import TrainConfig
    assert TrainConfig().batch_size == DEFAULT_BATCH
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    errs = {"main": dict.fromkeys(TRAIN_KERNELS, 0.0),
            "mmfi": dict.fromkeys(TRAIN_KERNELS, 0.0)}
    inputs16 = {"main": [], "mmfi": []}
    for label, n, length, group in train_axes():
        main = group == "main"
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
            if dt == torch.bfloat16 and group:
                errs[group] = {x: max(v, e[x])
                               for x, v in errs[group].items()}
        if group:
            inputs16[group].append((qkv.to(torch.bfloat16), scale,
                                    dout.to(torch.bfloat16), dsums))
    torch.cuda.synchronize()
    return inputs16, errs


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


def seeded_state(cfg, dev, optim=None):
    """A train state of ``cfg`` (a ``ModelConfig`` or an
    ``MMFiModelConfig``) on ``dev`` with the weights and dropout masks of
    ``SEED``."""
    from wiflow_tpu_torch.core.config import ModelConfig, OptimConfig
    from wiflow_tpu_torch.models.wiflow_mmfi import WiFlowMMFiModel
    from wiflow_tpu_torch.train.steps import create_train_state
    optim = optim or OptimConfig()
    if isinstance(cfg, ModelConfig):
        return create_train_state(cfg, optim, seed=SEED, device=dev)
    model = WiFlowMMFiModel(cfg, device=dev,
                            generator=torch.Generator().manual_seed(SEED))
    model.dropout_generator.manual_seed(SEED)
    return create_train_state(optim=optim, model=model)


def fp32_step(dev, cfg, xb, yb, ctx=None, hooks=None):
    """One fp32 train step of ``cfg`` on ``dev`` with the weights and
    dropout masks of ``SEED`` (cuDNN deterministic, so that two runs differ
    only in what is named), under ``hooks`` where given: its metrics, every
    gradient leaf and every running statistic."""
    from wiflow_tpu_torch.train.steps import train_step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        st = seeded_state(cfg, dev)
        with ctx or contextlib.nullcontext():
            m = train_step(st, xb.to(dev), yb.to(dev), hooks=hooks)
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


# The clock cycles of the spin that ``queued_ms`` queues its calls behind
# (about 50 ms at the H100's clock), and the calls it queues of a loop over
# one step's stage or join launches: few enough that their kernels (up to
# ~200 a call) stay well within the queue of pending launches, which the
# host would wait on while the card spins.
SPIN_CYCLES = 100_000_000
LOOP_RUNS = 3
# Calls that open ``device_ms``'s profiler window and are not counted.
PROFILER_WARMUP = 3


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
    time again.  The profiler drops some launches of a few microseconds:
    where a kernel's count over the steps is not a whole number a step,
    the log and ``SUMMARY`` give the busy time as a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            step()
        torch.cuda.synchronize()
    rows, dropped = [], False
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CPU
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / runs / 1e3, e.count / runs, e.key))
            dropped |= e.count % runs != 0
    if not rows:
        raise AssertionError(f"torch.profiler recorded no device time in "
                             f"{runs} of the {what}")
    busy = sum(r[0] for r in rows)
    at_least = "at least " if dropped else ""
    log(f"  torch.profiler, {runs} steps: device busy {at_least}{busy:.4f} "
        f"ms per step = {busy / step_ms:.1%} of the {step_ms:.4f} ms step "
        f"(idle {'at most ' if dropped else ''}{1 - busy / step_ms:.1%}), "
        f"{sum(r[1] for r in rows):g} device events per step"
        + ("; some launches dropped (a kernel's count is not whole a step)"
           if dropped else ""))
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
    SUMMARY.append(f"{what} {step_ms:.4f} ms, device busy {at_least}"
                   f"{busy:.4f}, train kernels {ms:.4f} x{count:g}")
    log("  largest kernels by self device time:")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"    {ms:8.4f} ms {ms / busy:6.1%} x{count:g} {key[:90]}")


def device_ms(fn, runs: int = 10) -> float:
    """The device's busy time in one ``fn()``: the sum of its kernels'
    durations (``torch.profiler``), for the sweep scripts that time one
    design against another (``join_sweep.py``, ``logits_sums_sweep.py``,
    ``train_attention_sweep.py``); this script reads ``queued_ms``.  The
    profiler drops launches of a few microseconds, so a reading is
    refused where it recorded no kernel, or a kernel a number of times
    that is not whole a call.  The window opens with ``PROFILER_WARMUP``
    calls that are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    seen = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=PROFILER_WARMUP,
                                   active=runs),
                 on_trace_ready=lambda p: seen.append(p.key_averages())
                 ) as prof:
        for _ in range(PROFILER_WARMUP + runs):
            fn()
            torch.cuda.synchronize()
            prof.step()
    times = []
    for e in seen[0]:
        if (e.device_type == DeviceType.CPU
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if us <= 0:
            continue
        if e.count % runs:
            raise AssertionError(f"torch.profiler recorded {e.key[:60]} "
                                 f"{e.count} times in {runs} calls: it "
                                 f"dropped launches")
        times.append(us / runs / 1e3)
    if not times:
        raise AssertionError("torch.profiler recorded no kernel")
    return sum(times)


def queued_ms(fn, runs: int = 50) -> float:
    """The device's time for one ``fn()`` from CUDA events around ``runs``
    calls queued behind a spin kernel (``torch.cuda._sleep``): the host
    enqueues them while the card spins, so the card runs them back to back
    and the events read its time, not the host's pace.  A spin too short
    for the host's enqueue is doubled and the reading taken again.  This
    is the script's device time of a kernel: ``torch.profiler`` drops
    launches of a few microseconds (none of the MM-Fi step's train-kernel
    launches were recorded in some windows), and a sum over the launches
    it kept reads low."""
    fn()
    torch.cuda.synchronize()
    for spin_cycles in (SPIN_CYCLES, 2 * SPIN_CYCLES, 4 * SPIN_CYCLES):
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(spin_cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        enqueue = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if enqueue < s.elapsed_time(a):
            return a.elapsed_time(b) / runs
    raise AssertionError(f"the host took {enqueue:.3f} ms to enqueue {runs} "
                         f"calls, longer than a spin of {spin_cycles} cycles")


def train_timings(state, xb, yb, main16, c, g, launches, errs):
    """Phase 7: the train step, then each train kernel alone (both axes,
    as one train step launches it) against its plain version, its bound
    and, for ``axial_core``, ``scaled_dot_product_attention``."""
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
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

    times = train_kernel_times(main16, c, g)
    record = []
    for name, t in times.items():
        kern = getattr(tk, KERNEL_ATTRS[name])
        record.append({"name": name, "route": "cuda", "source": kern.source,
                       "replaces": kern.replaces, "launches": launches[name],
                       "max_abs_err": errs[name], "ms": t["ms"],
                       "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                       "bound_by": t["bound_by"],
                       "library_ms": t["library_ms"],
                       "device_queued_ms": t["device_queued_ms"]})
        SUMMARY.append(f"{name} queued {t['device_queued_ms']:.4f} events "
                       f"{t['ms']:.4f} ms")
    share = sum(r["ms"] for r in record)
    log(f"  the four train kernels alone: {share:.4f} ms = "
        f"{share / step_ms:.1%} of the train step")
    sums_host_times(main16[0][0].device, c, g)
    return record


def train_kernel_times(inputs16, c, g):
    """Each train kernel over the bf16 inputs of both axes (as one train
    step launches it): CUDA events and the device's time (``queued_ms``),
    its bound, its plain version and, for ``axial_core``,
    ``scaled_dot_product_attention``.  Returns a dict by kernel name."""
    import torch.nn.functional as F
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
    from wiflow_tpu_torch.ops.kernels.build import sm_count

    def grad_graphs(fn, inputs):
        """Plain forward graphs to time the plain backward on."""
        graphs = []
        for leaves, cot in inputs:
            leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
            graphs.append((fn(*leaves), leaves, cot))
        return lambda: [torch.autograd.grad(o, lv, d, retain_graph=True)
                        for o, lv, d in graphs]

    core = [((*qkv.split(c, dim=-1), s), d) for qkv, s, d, _ in inputs16]
    pairs = [(tuple(qkv.split(c, dim=-1)[:2]), ds)
             for qkv, _, _, ds in inputs16]
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
            grad_graphs(tk.axial_core_plain, core),
            sdpa_fwd_bwd),
        "logits_sums_fwd": (
            lambda: [tk.logits_sums_forward(*a, g) for a, _ in pairs],
            lambda: [sums_fn(*a) for a, _ in pairs], None),
        "logits_sums_bwd": (
            lambda: [tk.logits_sums_backward(*a, d) for a, d in pairs],
            grad_graphs(sums_fn, pairs), None),
    }
    shapes = [(qkv.shape[0], qkv.shape[1]) for qkv, *_ in inputs16]
    for n, length in shapes:
        plan = tk.train_attention_plan(n, length, c, g, torch.bfloat16,
                                       sm_count(0))
        log(f"  axial_core's plan, n={n}, L={length}: {plan}")
    times = {}
    for name, (kfn, pfn, lfn) in cases.items():
        ms = time_ms(kfn, RUNS)
        queued = queued_ms(kfn)
        plain_ms = time_ms(pfn, max(3, RUNS // 4))
        lib_ms = time_ms(lfn, RUNS) if lfn else None
        flops, nbytes = train_work(name, shapes, c, g, 2)
        bms, by = bound_ms(flops, nbytes, torch.bfloat16)
        log(f"  {name} (both axes): kernel {ms:.4f} ms (queued behind a spin "
            f"{queued:.4f} ms), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention "
            + ("n/a" if lib_ms is None else f"{lib_ms:.4f} ms")
            + f", bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e9:.4f} GB)")
        times[name] = {"ms": ms, "device_queued_ms": queued,
                       "plain_ms": plain_ms,
                       "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}
    return times


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
    hold_stages(sk, stage_cases, gen, dev, keep, errs, TRAIN_BATCH)
    hold_joins(sk, join_cases, gen, dev, keep, errs, TRAIN_BATCH,
               workspace_checks=True)
    torch.cuda.synchronize()
    log("  every stage and join launch, run twice on the same inputs, gave "
        "the same bits")
    return errs


def hold_stages(sk, cases, gen, dev, keep, errs, main_batch):
    """Each ``stage`` launch of ``cases``, forward and backward, against its
    plain version on seeded inputs: fp32 with TF32 off, the sums and the
    prologue's gradients also against float64, and bf16 against the fp32
    plain version; a second launch must repeat the first bit for bit.
    ``errs`` keeps the largest bf16 error of the launches at
    ``main_batch`` samples: of ``out`` forward, of the input gradient
    backward."""
    names = ("gx", "g_m", "g_a", "g_b", "gw", "gbias")
    for c in cases:
        i = stage_inputs(c, gen, dev, keep)
        kw = dict(kind=c["kind"], dil=c["dil"], keep=keep)
        fn = lambda x, m, a, b, w, bias: sk.stage_plain(  # noqa: E731
            x, m, a, b, i["mask"], w, bias, **kw)
        leaves = (i["x"], i["m"], i["a"], i["b"], i["w"], i["bias"])
        cots = (i["go"], i["gs"])
        (o32, s32), g32 = plain_grads(fn, leaves, cots, torch.float32)
        (_, s64), g64 = plain_grads(fn, leaves, cots, torch.float64)
        main = c["lead"][0] == main_batch
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


def hold_joins(sk, cases, gen, dev, keep, errs, main_batch,
               workspace_checks=False):
    """Each ``join`` launch of ``cases`` as :func:`hold_stages` holds a
    stage; the bf16 ``gh`` and ``gres`` against the fp32 chain rule at the
    kernels' rounding points.  ``workspace_checks``: the backward's
    workspace checks on the first case."""
    names = ("gh", "g_m_h", "g_a_h", "g_b_h", "gres", "g_m_r", "g_a_r",
             "g_b_r")
    for c in cases:
        i = join_inputs(c, gen, dev, keep)
        kw = dict(keep=keep, act_h=c["act_h"])
        fn = lambda h, mh, ah, bh, res, mr, ar, br: (sk.join_plain(  # noqa: E731
            h, mh, ah, bh, i["mask"], res, mr, ar, br, **kw),)
        main = c["lead"][0] == main_batch
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
            if workspace_checks and c is cases[0] and dt == torch.bfloat16:
                join_workspace_checks(sk, got, backward, cases, gen, dev,
                                      keep)
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
    log(f"phase 10: stage and join timings, bf16, batch {TRAIN_BATCH} (CUDA "
        f"events, median of {RUNS})")
    record = stage_kernel_timings(dev, cfg, launches, errs)
    join_host_times(dev)
    fused_step_timings(stock_state, fused_state, xb, yb, record)
    return record


def stage_kernel_timings(dev, cfg, launches, errs, batch=TRAIN_BATCH,
                         per_launch=True, what=""):
    """The kernel half of phase 10 (and of phase 15's timings, for the
    MM-Fi model): ``stage`` and ``join`` over the launches of one fused
    step of ``cfg`` at ``batch``, and with ``per_launch`` each distinct
    launch alone.  Returns the record rows of ``stage`` and ``join``,
    forward and backward."""
    import torch.nn.functional as F
    from wiflow_tpu_torch.ops.kernels import stage_fused as sk
    keep = 1.0 - cfg.dropout
    dt = torch.bfloat16
    stages, joins = sk.step_launches(cfg, batch)
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
    if per_launch:
        log("  per launch: kernel / plain / bound ms, forward then "
            "backward (CUDA events: a launch of a few microseconds reads as "
            "the host's time to enqueue it); F.conv where the stage is a "
            "bare convolution; the device's time queued behind a spin; the "
            "plan's path of the forward, the input gradient and the weight "
            "gradient")
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
                f"; queued fwd {queued_ms(f['fwd']):.4f}, bwd "
                f"{queued_ms(f['bwd']):.4f}{path}")

    # summed over the launches of one train step
    record, join_queued = [], []
    for name, fns, work, key in (("stage_fwd", sfn, swork, "fwd"),
                                 ("stage_bwd", sfn, swork, "bwd"),
                                 ("join_fwd", jfn, jwork, "fwd"),
                                 ("join_bwd", jfn, jwork, "bwd")):
        # the host's time to enqueue the loop beside the device's time to
        # run it: which of the two paces the launches
        ms, enqueue_ms = time_step_ms(lambda: [f[key]() for f in fns], RUNS)
        device = queued_ms(lambda: [f[key]() for f in fns], LOOP_RUNS)
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
               "enqueue_ms": enqueue_ms, "device_queued_ms": device}
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
            row["library_device_queued_ms"] = queued_ms(
                lambda: [f["lib"]() for f in bare], LOOP_RUNS)
            row["device_queued_ms_of_library_launches"] = queued_ms(
                lambda: [f["fwd"]() for f in bare], LOOP_RUNS)
            lib += (f"; the {len(bare)} launches that are bare convolutions: "
                    f"kernel {row['ms_of_library_launches']:.4f} ms (queued "
                    f"{row['device_queued_ms_of_library_launches']:.4f}), "
                    f"F.conv {row['library_ms']:.4f} ms (queued "
                    f"{row['library_device_queued_ms']:.4f})")
        if name.startswith("join"):
            join_queued.append(device)
        log(f"  {name}, the {len(fns)} launches of one {what}step: kernel "
            f"{ms:.4f} ms (the host enqueues the loop in {enqueue_ms:.4f} "
            f"ms; queued behind a spin, the device runs it in {device:.4f} "
            f"ms), plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"(mostly {by}; {sum(w[which][0] for w in work) / 1e9:.3f} "
            f"GFLOP, {sum(w[which][1] for w in work) / 1e9:.4f} GB){lib}")
        record.append(row)
    SUMMARY.append(f"join fwd / bwd queued over the {what}step's "
                   f"{len(joins)} launches {join_queued[0]:.4f} / "
                   f"{join_queued[1]:.4f} ms")
    del sfn, jfn
    torch.cuda.empty_cache()
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
    log(f"phase 10: stage and join timings, bf16, batch {TRAIN_BATCH} (CUDA "
        f"events, median of {RUNS})")
    record = stage_kernel_timings(dev, cfg, dict.fromkeys(STAGE_ATTRS, 0),
                                  errs)
    join_host_times(dev)
    return record


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


# Phase 4's stock-op lowerings of ``fast_forward``: (fuse_tcn,
# fuse_conv_stack) off the default, and the kernels each still launches.
LOWERINGS = ((False, True), (True, False), (False, False))

# Phase 4's bf16 checks of the stock lowerings on ``lively_state``'s
# weights (the seeded model serves nearly one output for every row, so
# only these show a wrong bf16 lowering).  Each stock layer, on the
# card's bf16 input of LAYER_ROWS rows, is held to the same layer on the
# CPU, whose stock ops round where the JAX package's stock ops round
# (tests/test_torch_fast_lowerings.py): at most STOCK_LAYER_DIFFERING of
# its values may differ, by at most STOCK_LAYER_MAX of max|ref|; the
# control, silu rounded once (``F.silu``) in the first TCN level, must
# miss the share.  End to end, each stock lowering in bf16 is held to the
# fp32 module and to the default lowering in bf16 at LIVELY_BF16 x
# max|ref|; the control, the stock path with the shortcut of residual
# block 1 folded 1.25x too large, must miss it.  The same mis-folding in
# the first TCN level moves the output by no more than bf16 noise does
# (logged, not held): end to end, bf16 sees only a coarse fault, and a
# folding fault is the fp32 checks' to find.  The limits lie between the
# sound readings and the controls' on the H100 (PERF.md, phase 4).
LAYER_ROWS = 64
STOCK_LAYER_DIFFERING = 0.05
STOCK_LAYER_MAX = 2.0 ** -7
LIVELY_BF16 = 0.12


def lively_state(sd):
    """``sd`` with every BatchNorm's scale times 1.7 (1 + sin / 2) and its
    shift plus cos / 10: the seeded model serves nearly one output for
    every row, this one an output that varies (``check_spread``)."""
    out = dict(sd)
    for k, v in sd.items():
        bn = k.rsplit(".", 1)[0]
        if f"{bn}.running_var" not in sd or v.ndim != 1:
            continue
        i = torch.arange(v.numel(), device=v.device, dtype=torch.float32)
        if k.endswith(".weight"):
            out[k] = v * 1.7 * (1 + 0.5 * torch.sin(i))
        elif k.endswith(".bias"):
            out[k] = v + 0.1 * torch.cos(i)
    return out


def bf16_distance(got, ref):
    """(share of the values that differ, max|got - ref| / max|ref|)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got != ref).float().mean().item(),
            ((got - ref).abs().max() / ref.abs().max()).item())


def stock_layers_bf16(dev, live, x):
    """Each stock layer of the bf16 pack of ``live`` on the card, chained
    on the card's outputs from ``x``'s first LAYER_ROWS rows, against the
    same layer on the CPU on the same bf16 input; then the control, the
    first TCN level with ``F.silu``.  Logs every reading and returns
    (the layers' largest share, their largest max, the control's share)."""
    import torch.nn.functional as F
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.models import fast
    on_card = fast.pack_fast(live, ModelConfig(), device=dev)
    on_cpu = fast.pack_fast({k: v.cpu() for k, v in live.items()},
                            ModelConfig(), device="cpu")
    layers = [(f"tcn level {i}", fast._stock_tcn_level, d, c)
              for i, (d, c) in enumerate(zip(on_card.stock_tcn,
                                             on_cpu.stock_tcn))]
    layers += [(f"conv block {k}", fast._stock_conv_block, d, c)
               for k, (d, c) in enumerate(zip(on_card.stock_conv,
                                              on_cpu.stock_conv))]
    h = x[:LAYER_ROWS].to(torch.bfloat16).transpose(1, 2).contiguous()
    first = h
    shares, maxes = [], []
    for name, fn, w_card, w_cpu in layers:
        if name == "conv block 0":
            h = h[..., None]
        got = fn(w_card, h)
        share, worst = bf16_distance(got, fn(w_cpu, h.cpu()))
        log(f"  stock {name} bf16, lively weights, card vs CPU: "
            f"{share:.4%} of values differ, max {worst:.3e} x max|ref|")
        shares.append(share)
        maxes.append(worst)
        h = got
    silu, fast._silu = fast._silu, F.silu
    try:
        got = fast._stock_tcn_level(on_card.stock_tcn[0], first)
    finally:
        fast._silu = silu
    control, cmax = bf16_distance(
        got, fast._stock_tcn_level(on_cpu.stock_tcn[0], first.cpu()))
    log(f"  control, stock tcn level 0 with F.silu on the card vs CPU: "
        f"{control:.4%} of values differ, max {cmax:.3e} x max|ref|")
    return max(shares), max(maxes), control


def lively_bf16(dev, live, live_ref, x32):
    """Phase 4, the stock lowerings in bf16 on ``lively_state``'s weights:
    the layers (``stock_layers_bf16``) and each lowering end to end
    against the fp32 module ``live_ref`` and the default lowering, with
    the controls; every reading is logged before the limits are held."""
    import dataclasses
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.models.fast import fast_forward, pack_fast
    share, worst, control = stock_layers_bf16(dev, live, x32)
    live16 = pack_fast(live, ModelConfig(), device=dev)
    default = fast_forward(live16, x32)
    scale = live_ref.abs().max().item()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.abs().max()).item()

    readings = {"default lowering bf16 vs module fp32":
                rel(default, live_ref)}
    for fuse_tcn, fuse_conv in LOWERINGS:
        flags = dict(fuse_tcn=fuse_tcn, fuse_conv_stack=fuse_conv)
        name = f"fuse_tcn={fuse_tcn}, fuse_conv_stack={fuse_conv}"
        y = fast_forward(live16, x32, **flags)
        if not torch.isfinite(y).all():
            raise AssertionError(f"{name}, lively weights bf16: non-finite")
        readings[f"{name} bf16 vs module fp32"] = rel(y, live_ref)
        readings[f"{name} bf16 vs default lowering bf16"] = rel(y, default)
    lv, blk = live16.stock_tcn[0], live16.stock_conv[2]
    bad_tcn = dataclasses.replace(live16, stock_tcn=(
        lv._replace(g1=(lv.g1[0] * 1.25, lv.g1[1])),
        *live16.stock_tcn[1:]))
    bad = dataclasses.replace(live16, stock_conv=(
        *live16.stock_conv[:2],
        blk._replace(down=(blk.down[0] * 1.25, blk.down[1])),
        *live16.stock_conv[3:]))
    stock = dict(fuse_tcn=False, fuse_conv_stack=False)
    bad_rel = rel(fast_forward(bad, x32, **stock), live_ref)
    tcn_rel = rel(fast_forward(bad_tcn, x32, **stock), live_ref)
    for name, r in readings.items():
        log(f"  lively weights, {name}: {r:.6e} x max|ref| "
            f"(max|ref| {scale:.4e}, limit {LIVELY_BF16:g})")
    log(f"  lively weights, control (stock path, residual block 1's "
        f"shortcut folded 1.25x) bf16 vs module fp32: {bad_rel:.6e} x "
        f"max|ref|; the same in TCN level 0's first grouped conv (not "
        f"held): {tcn_rel:.6e}")
    SUMMARY.append(
        f"lively bf16: layers {share:.4%} differ max {worst:.3e}, control "
        f"{control:.4%}; end to end worst "
        f"{max(readings.values()):.4e}, control {bad_rel:.4e}")
    if share > STOCK_LAYER_DIFFERING or worst > STOCK_LAYER_MAX:
        raise AssertionError(
            f"a stock layer in bf16 on the card strays from the CPU's "
            f"rounding: {share:.4%} of values differ, max {worst:.3e}")
    if not control > STOCK_LAYER_DIFFERING:
        raise AssertionError(
            f"the F.silu control reads {control:.4%}: the layer check cannot "
            f"tell where a lowering rounds")
    bad_names = [n for n, r in readings.items() if r > LIVELY_BF16]
    if bad_names:
        raise AssertionError(f"lively weights bf16 over {LIVELY_BF16}: "
                             f"{bad_names}")
    if not bad_rel > LIVELY_BF16:
        raise AssertionError(
            f"the mis-folded control reads {bad_rel:.4e}: the end-to-end "
            f"bf16 check cannot tell a wrong lowering")


def stock_lowerings(dev, all_kernels, sd, packed32, packed16, x32, ref_out,
                    out16):
    """Phase 4, the stock-op lowerings: ``fast_forward`` with
    ``fuse_tcn=False``, ``fuse_conv_stack=False`` and both, in bf16 at
    batch 4096, each held to the plain fp32 module and to the default
    lowering at ``TOL_BF16`` (and in fp32 to the module at ``TOL_F32``),
    and in fp32 on the same weights with their BatchNorms spread
    (``lively_state``), whose output varies over the rows, to the module
    at ``TOL_F32``, and in bf16 on those weights (``lively_bf16``: their
    gains take even the kernels' own lowering past ``TOL_BF16``); the
    kernels launched (the TCN kernel none without ``fuse_tcn``, the conv
    stack none without ``fuse_conv_stack``, the attention 2) and the
    windows/s of each."""
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.models.fast import fast_forward, pack_fast
    from wiflow_tpu_torch.models.torch_compat import load_state_dict
    from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
    b = x32.shape[0]
    log(f"phase 4: the stock-op lowerings of fast_forward, batch {b}")
    live = lively_state(sd)
    live_ref = load_state_dict(WiFlowPoseModel(ModelConfig(
        compute_dtype="float32"), device=dev), live)(x32)
    check_spread("lively weights: module fp32", live_ref)
    live32 = pack_fast(live, ModelConfig(compute_dtype="float32"), device=dev)
    compare("lively weights: default lowering fp32 vs module fp32",
            fast_forward(live32, x32), live_ref, TOL_F32)
    lively_bf16(dev, live, live_ref, x32)
    default_ms = time_ms(lambda: fast_forward(packed16, x32), RUNS)
    rates = [f"default {b / default_ms * 1e3:.1f}"]
    for fuse_tcn, fuse_conv in LOWERINGS:
        flags = dict(fuse_tcn=fuse_tcn, fuse_conv_stack=fuse_conv)
        name = f"fuse_tcn={fuse_tcn}, fuse_conv_stack={fuse_conv}"
        reset_launches(all_kernels)
        y16 = fast_forward(packed16, x32, **flags)
        expect_launches(f"fast_forward({name})", read_launches(all_kernels),
                        {"tcn_level": len(packed16.tcn) if fuse_tcn else 0,
                         "conv_stack": 1 if fuse_conv else 0,
                         "axial_attention": 2})
        compare(f"{name}: bf16 vs module fp32", y16, ref_out, TOL_BF16)
        compare(f"{name}: bf16 vs the default lowering bf16", y16, out16,
                TOL_BF16)
        compare(f"{name}: fp32 vs module fp32",
                fast_forward(packed32, x32, **flags), ref_out, TOL_F32)
        compare(f"{name}, lively weights: fp32 vs module fp32",
                fast_forward(live32, x32, **flags), live_ref, TOL_F32)
        ms = time_ms(lambda: fast_forward(packed16, x32, **flags), RUNS)
        log(f"  fast_forward({name}) bf16 batch {b}: {ms:.4f} ms = "
            f"{b / ms * 1e3:.1f} windows/s (default lowering {default_ms:.4f}"
            f" ms in the same turn)")
        rates.append(f"tcn {int(fuse_tcn)} conv {int(fuse_conv)} "
                     f"{b / ms * 1e3:.1f}")
    SUMMARY.append("fast_forward windows/s by lowering: " + ", ".join(rates))


def build_kernels(only=None):
    """Phase 1.  Returns nvidia-smi's line for the card, the three kernels
    of the default serving path and every kernel of the port, by name.
    ``only`` names the libraries to build and load, all of them if None."""
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as train_k
    from wiflow_tpu_torch.ops.kernels import build as kbuild
    from wiflow_tpu_torch.ops.kernels import channel_attention as ca_k
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
    all_kernels = {**kernels, "channel_attention": ca_k.KERNEL,
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
                if (lib in SASS_WGMMA and "_kernel" in fn
                        and (counts["HGMMA"] > 0) != bf16):
                    raise AssertionError(
                        f"{lib} {fn}: HGMMA {counts['HGMMA']}; the bf16 "
                        f"kernels must run their products on wgmma, the "
                        f"fp32 ones on CUDA cores")
            if lib in (*SASS_CHECKED, *SASS_WGMMA) and kinds != {"bf16",
                                                                  "fp32"}:
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
    stock_lowerings(dev, all_kernels, sd, packed32, packed16, x32, ref_out,
                    out16)

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


def cli_main(argv, name="run"):
    """``wiflow_tpu_torch.cli.<name>.main(argv)`` in this process: must
    return 0; returns what it printed."""
    import importlib
    cli = importlib.import_module(f"wiflow_tpu_torch.cli.{name}")
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli.{name}.main({argv}) returned {rc}")
    return tee.kept.getvalue()


@contextlib.contextmanager
def watched_steps(all_kernels, augmented=True):
    """Wraps ``train/steps.py::train_step`` for one run: the first step's
    launches are read (each train kernel must launch twice), the second
    runs with host syncs forbidden and, where ``augmented``, must augment.
    Yields the count of steps taken."""
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
            if augmented and kw.get("augment") is None:
                raise AssertionError("the resumed epoch's step does not "
                                     "augment")
            torch.cuda.set_sync_debug_mode("error")
            try:
                m = inner(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            log(f"  one {'augmented ' if augmented else ''}train step of the "
                f"resumed run ran with no host sync "
                f"(torch.cuda.set_sync_debug_mode('error'))")
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


def epoch_numbers(what, timings, windows, unit="windows"):
    """Logs one run's seconds per epoch, training windows (or frames) a
    second, host share and write times."""
    rates = [windows / t for t in timings["train_s"]]
    share = [e / t for e, t in zip(timings["enqueue_s"], timings["train_s"])]
    log(f"  {what}: seconds per epoch "
        + ", ".join(f"{t:.3f}" for t in timings["epoch_s"])
        + f"; training {unit}/s "
        + ", ".join(f"{r:.1f}" for r in rates)
        + "; the host's share of an epoch's training (its enqueue time) "
        + ", ".join(f"{100 * v:.1f}%" for v in share)
        + "; bundle writes " + ", ".join(f"{t:.4f}" for t in
                                          timings["bundle_s"])
        + " s; best-weight writes " + ", ".join(f"{t:.4f}" for t in
                                                timings["best_s"]) + " s")
    return rates, share


@torch.no_grad()
def cli_test_split(data_dir):
    """The CLI's test split of ``data_dir`` (its file-level split at seed
    42): windows and true keypoints, numpy."""
    from wiflow_tpu_torch.data.dataset import CSIKeypointsDataset
    from wiflow_tpu_torch.data.splits import (
        expand_to_samples, file_level_split,
    )
    ds = CSIKeypointsDataset(data_dir)
    test_files = file_level_split(ds.num_files, seed=42)[2]
    return ds.materialize(expand_to_samples(ds.window_ranges, test_files))


def serve_trained(dev, all_kernels, out, data_dir):
    """Phase 14, step 4: the best weights in ``out`` served through
    ``fast_forward`` and held to the plain module; returns the output's std
    over the batch and max|output|."""
    import numpy as np
    from wiflow_tpu_torch.core.checkpoint import load_best_model
    from wiflow_tpu_torch.core.config import ModelConfig
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
    x, _ = cli_test_split(data_dir)
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
    """Phase 14: train from the CLI, resume, and serve what it trained.
    Returns the best weights (a CPU ``state_dict``) and the CLI's test
    split, which phase 18 sweeps."""
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
        from wiflow_tpu_torch.core.checkpoint import load_best_model
        return (load_best_model(os.path.join(out, "best_pose_model.pth")),
                cli_test_split(data))


def mmfi_tree(root):
    """Phase 15 (a): a learnable synthetic MM-Fi tree, ``MMFI_SUBJECTS`` x
    ``MMFI_ACTIONS`` x MM-Fi's 297 frames a sequence, and the counts of
    the CLI's default split of it."""
    from wiflow_tpu_torch.cli.run_mmfi import DEFAULT_CONFIG
    from wiflow_tpu_torch.data.mmfi import (
        FRAMES_PER_SEQUENCE, generate_synthetic_mmfi, make_dataset,
        split_val_test,
    )
    t0 = time.perf_counter()
    generate_synthetic_mmfi(root, subjects=MMFI_SUBJECTS,
                            actions=MMFI_ACTIONS, frames=FRAMES_PER_SEQUENCE,
                            fmt="npy", learnable=True)
    secs = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)
    train_ds, val_ds = make_dataset(root, DEFAULT_CONFIG)
    val, test = split_val_test(len(val_ds))
    frames = len(MMFI_SUBJECTS) * len(MMFI_ACTIONS) * FRAMES_PER_SEQUENCE
    log(f"  (a) a learnable synthetic MM-Fi tree: {len(MMFI_SUBJECTS)} "
        f"subjects x {len(MMFI_ACTIONS)} actions x {FRAMES_PER_SEQUENCE} "
        f"frames = {frames} frames, {size / 1e6:.1f} MB of .npy, written in "
        f"{secs:.2f} s; the CLI's split ({DEFAULT_CONFIG['protocol']}, "
        f"{DEFAULT_CONFIG['split_to_use']}): train {len(train_ds)}, val "
        f"{len(val)}, test {len(test)}")
    if len(train_ds) + len(val) + len(test) != frames or not len(test):
        raise AssertionError("the split does not cover the tree")


def mmfi_data(tree, out):
    """The CLI's train, val and test splits of ``tree``, from the caches
    it wrote in ``out``."""
    from wiflow_tpu_torch.cli.run_mmfi import DEFAULT_CONFIG
    from wiflow_tpu_torch.data.mmfi import make_dataset, split_val_test
    train_ds, val_ds = make_dataset(tree, DEFAULT_CONFIG)
    train = train_ds.materialize(os.path.join(out, "mmfi_train_cache.npz"))
    x, y = val_ds.materialize(os.path.join(out, "mmfi_val_cache.npz"))
    vi, ti = split_val_test(len(val_ds))
    return train, (x[vi], y[vi]), (x[ti], y[ti])


@torch.no_grad()
def serve_trained_mmfi(dev, all_kernels, out, test):
    """Phase 15 (c): the best weights in ``out`` served through
    ``fast_forward_mmfi`` and held to the plain module, and the
    root-relative metrics of the served batch on the card against the same
    on the CPU; returns the output's std over the batch and
    max|output|."""
    import numpy as np
    from wiflow_tpu_torch.core.checkpoint import load_best_model
    from wiflow_tpu_torch.metrics import mmfi_metrics as mm
    from wiflow_tpu_torch.models.fast import fast_forward_mmfi, pack_fast_mmfi
    from wiflow_tpu_torch.models.torch_compat import load_state_dict
    from wiflow_tpu_torch.models.wiflow_mmfi import (
        MMFiModelConfig, WiFlowMMFiModel,
    )
    sd = load_best_model(os.path.join(out, "best_pose_model.pth"))
    msg = load_best_model(os.path.join(out, "best_pose_model.msgpack"),
                          MMFiModelConfig())
    if sorted(msg) != sorted(k for k in sd if not k.endswith(
            "num_batches_tracked")) or not all(
                torch.equal(v, sd[k]) for k, v in msg.items()):
        raise AssertionError("best_pose_model.msgpack and .pth differ")
    log(f"  best_pose_model.msgpack gives the .pth's state_dict bit for bit "
        f"({len(msg)} tensors)")
    n = len(test[0])
    reps = -(-BATCH // n)
    x = torch.from_numpy(np.ascontiguousarray(test[0])).to(dev).repeat(
        reps, 1, 1, 1)[:BATCH]
    y = torch.from_numpy(test[1]).to(dev).repeat(reps, 1, 1)[:BATCH]
    packed = pack_fast_mmfi(sd, MMFiModelConfig(), device=dev)
    reset_launches(all_kernels)
    out16 = fast_forward_mmfi(packed, x)
    expect_launches("fast_forward_mmfi of the trained weights",
                    read_launches(all_kernels),
                    {"tcn_level": len(packed.tcn), "conv_stack": 1,
                     "axial_attention": 2})
    ref = load_state_dict(WiFlowMMFiModel(MMFiModelConfig(
        compute_dtype="float32"), device=dev), sd)(x)
    compare(f"trained weights: fast_forward_mmfi bf16 vs module fp32, the "
            f"test split's {n} frames repeated to {BATCH}", out16, ref,
            TOL_BF16)
    thresholds = (0.1, 0.2, 0.3, 0.4, 0.5)
    for name, fn in (
            ("root_relative_pck_fractions",
             lambda p, t: mm.root_relative_pck_fractions(p, t, thresholds)),
            ("root_aligned_mpjpe", mm.root_aligned_mpjpe)):
        card, host = fn(out16, y), fn(out16.cpu(), y.cpu())
        diff = (card.cpu() - host).abs().max().item()
        log(f"  MM-Fi metric {name} of the served batch: card vs CPU "
            f"max_abs_diff={diff:.3e} (limit 1e-4), value "
            f"{[round(v, 6) for v in card.flatten().tolist()]}")
        if card.device != out16.device or not diff <= 1e-4:
            raise AssertionError(f"MM-Fi metric {name}: card and CPU differ "
                                 f"by {diff}")
    spread = out16.std(dim=0).mean().item()
    top = out16.abs().max().item()
    log(f"  served output: std over the batch {spread:.4e} (mean over the "
        f"{out16[0].numel()} outputs), max|output| {top:.4e}, bar "
        f"{MIN_SPREAD * top:.4e} (1/100 of max|output|): "
        f"{'reached' if spread >= MIN_SPREAD * top else 'NOT reached'}")
    return spread, top


def mmfi_cli_slice(dev, all_kernels, tmp):
    """Phase 15 (a)-(c): the tree, the MM-Fi CLI on it (a subprocess, a
    resume in this process, a run never stopped), the ``--synthetic``
    ``.mat`` tree, and the trained weights served.  Returns the CLI's
    splits and the launches of its step."""
    import glob
    import importlib.util
    root = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.join(tmp, "MMFi")
    mmfi_tree(tree)
    out, straight = (os.path.join(tmp, d) for d in ("mmfi_out",
                                                     "mmfi_straight"))
    flags = [*MMFI_CLI_FLAGS, "--lr", str(MMFI_LR), "--dataset_root",
             tree]
    cmd = [sys.executable, "-m", "wiflow_tpu_torch.cli.run_mmfi", *flags,
           "--output_dir", out, "--epochs", "2"]
    log(f"  (b) the MM-Fi CLI on the card: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    first = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                           timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    for line in first.stdout.splitlines():
        log(f"  | {line}")
    if first.returncode != 0:
        raise AssertionError(f"the MM-Fi CLI exited {first.returncode}:\n"
                             f"{first.stderr[-4000:]}")
    missing = [f for f in MMFI_CLI_FILES
               if not os.path.exists(os.path.join(out, f))]
    png = os.path.exists(os.path.join(out, "training_history.png"))
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    if missing or png != has_mpl or (
            not has_mpl and "skipped training_history.png"
            not in first.stdout):
        raise AssertionError(f"the MM-Fi CLI's files: missing {missing}, "
                             f"PNG {png} with matplotlib {has_mpl}")
    log(f"  the MM-Fi CLI exited 0 in {wall:.2f} s and wrote "
        + ", ".join(sorted(os.listdir(out))))
    first_hist = csv_rows(os.path.join(out, "training_history.csv"))
    first_t = run_timings(first.stdout)

    reset_launches(all_kernels)
    with watched_steps(all_kernels, augmented=False) as seen:
        text = cli_main([*flags, "--output_dir", out, "--epochs", "3"],
                        "run_mmfi")
    launches = read_launches(all_kernels)
    steps = seen["steps"]
    expect_launches(f"the resumed MM-Fi run ({steps} steps)", launches,
                    {n: 2 * steps for n in TRAIN_KERNELS})
    if "[resume] continuing from epoch 3 of 3" not in text or \
            "Epoch 3/3" not in text:
        raise AssertionError("the second MM-Fi call did not resume at "
                             "epoch 3")
    hist = csv_rows(os.path.join(out, "training_history.csv"))
    if len(hist) != 4 or hist[:3] != first_hist:
        raise AssertionError("the resumed MM-Fi history does not keep the "
                             "first run's rows")
    log("  resumed at epoch 3; history rows of epochs 1-2 equal the first "
        "run's")
    resumed_t = run_timings(text)
    straight_t = run_timings(cli_main(
        [*flags, "--output_dir", straight, "--epochs", "3"], "run_mmfi"))
    if same_run(out, straight):
        log("  resumed MM-Fi run vs the run never stopped: history and "
            "final weights equal bit for bit")
        SUMMARY.append("MM-Fi resume bit-equal")
    else:
        again = os.path.join(tmp, "mmfi_again")
        cli_main([*flags, "--output_dir", again, "--epochs", "3"],
                 "run_mmfi")
        noise = run_distance(again, straight)
        got = run_distance(out, straight)
        log(f"  resumed MM-Fi run vs the run never stopped: NOT bit-equal; "
            f"largest relative difference {got:.3e}, limit {2 * noise:.3e}"
            f" (twice that of two runs never stopped, {noise:.3e})")
        SUMMARY.append(f"MM-Fi resume within noise {got:.3e} <= "
                       f"{2 * noise:.3e}")
        if not got <= 2 * noise:
            raise AssertionError(f"MM-Fi resume differs by {got} > 2 x "
                                 f"{noise}")
    frames = steps * DEFAULT_BATCH
    epoch_numbers("first MM-Fi run (subprocess)", first_t, frames, "frames")
    epoch_numbers("resumed MM-Fi run", resumed_t, frames, "frames")
    rates, share = epoch_numbers("MM-Fi run never stopped", straight_t,
                                 frames, "frames")
    log(f"  first MM-Fi run's wall clock (process start, caches, 2 epochs, "
        f"artifacts): {wall:.2f} s")

    # --synthetic on a missing root: the JAX CLI's miniature .mat tree
    mat = os.path.join(tmp, "mmfi_synthetic")
    text = cli_main(["--synthetic", "--dataset_root", mat, "--output_dir",
                     os.path.join(tmp, "mmfi_synthetic_out"), "--epochs",
                     "1", "--no_videos"], "run_mmfi")
    mats = glob.glob(os.path.join(mat, "E*", "S*", "A*", "wifi-csi",
                                  "frame*.mat"))
    if "[synthetic] generating" not in text or not mats:
        raise AssertionError("--synthetic wrote no .mat tree")
    log(f"  --synthetic on a missing root: {len(mats)} .mat frames written "
        f"and trained on for 1 epoch, exit 0")

    # (c) the trained weights served
    data = mmfi_data(tree, out)
    spread, top = serve_trained_mmfi(dev, all_kernels, out, data[2])
    if not spread >= MIN_SPREAD * top:
        raise AssertionError(f"the served MM-Fi output hardly varies: std "
                             f"{spread} < {MIN_SPREAD} x {top}")
    SUMMARY.append(
        f"MM-Fi CLI first run {wall:.2f} s, epoch median "
        f"{statistics.median(straight_t['epoch_s']):.3f} s, "
        f"{statistics.median(rates):.1f} frames/s, host "
        f"{100 * statistics.median(share):.1f}%, served std after 3 "
        f"epochs at --lr {MMFI_LR:g} {spread:.3e} of max {top:.3e}")
    return data, {n: launches[n] // steps for n in TRAIN_KERNELS}


def mmfi_fused_slice(dev, all_kernels, data):
    """Phase 15 (d): the fused MM-Fi step.  Returns the launches of one
    step and each stage and join kernel's largest bf16 error at its
    launches."""
    from wiflow_tpu_torch.core.config import (
        MMFI_SKELETON_CONNECTIONS, Config, OptimConfig, TrainConfig,
    )
    from wiflow_tpu_torch.metrics import mmfi_metrics as mm
    from wiflow_tpu_torch.models.wiflow_mmfi import (
        MMFiModelConfig, WiFlowMMFiModel,
    )
    from wiflow_tpu_torch.ops.kernels import stage_fused as sk
    from wiflow_tpu_torch.train.loop import train_pose_model
    from wiflow_tpu_torch.train.steps import make_hooks, train_step
    cfg = MMFiModelConfig(**FUSED)
    stages, joins = sk.step_launches(cfg, DEFAULT_BATCH)
    log(f"  (d) the fused MM-Fi step: MMFiModelConfig({FUSED}) "
        f"({cfg.compute_dtype}, dropout {cfg.dropout}/{cfg.conv_dropout}), "
        f"batch {DEFAULT_BATCH}; step_launches: {len(stages)} stage and "
        f"{len(joins)} join launches each way")
    if (len(stages), len(joins)) != (34, 8):
        raise AssertionError(f"step_launches gives {len(stages)} stages and "
                             f"{len(joins)} joins for the MM-Fi model")
    expect = {**dict.fromkeys(TRAIN_KERNELS, 2),
              **{n: len(stages if n.startswith("stage") else joins)
                 for n in STAGE_ATTRS}}
    hooks = make_hooks(connections=MMFI_SKELETON_CONNECTIONS,
                       pck_fn=mm.root_relative_pck_fractions,
                       mpe_fn=mm.root_aligned_mpjpe)
    (tx, ty), _, _ = data
    xb = torch.from_numpy(tx[:DEFAULT_BATCH]).to(dev)
    yb = torch.from_numpy(ty[:DEFAULT_BATCH]).to(dev)
    state = seeded_state(cfg, dev, OptimConfig(weight_decay=1e-4))
    reset_launches(all_kernels)
    train_step(state, xb, yb, hooks=hooks)
    launches = read_launches(all_kernels)
    expect_launches("one fused MM-Fi step", launches, expect)
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(state, xb, yb, hooks=hooks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("  a second fused MM-Fi step ran with no host sync "
        "(torch.cuda.set_sync_debug_mode('error'))")

    # one fp32 step with dropout on, fused against stock ops, held to twice
    # the step's fp32 rounding noise (phase 9)
    kw = dict(compute_dtype="float32")
    off = MMFiModelConfig(dropout=0.0, conv_dropout=0.0, **kw)
    card = fp32_step(dev, off, xb.float(), yb, hooks=hooks)
    host = fp32_step("cpu", off, xb.float().cpu(), yb.cpu(), hooks=hooks)
    noise = max(leaf_noise(card[1], host[1], GRAD_FLOOR),
                leaf_noise(card[2], host[2], STAT_FLOOR),
                leaf_noise({"g": card[0]["grad_norm"]},
                           {"g": host[0]["grad_norm"]}, 0.0))
    tol = max(TOL_F32, 2.0 * noise)
    log(f"  fp32 rounding noise of one MM-Fi step (stock ops on the card vs "
        f"stock ops on the CPU, dropout 0): {noise:.3e}; the fused step is "
        f"held to {tol:.3e}")
    compare_fp32_steps("MM-Fi fused vs stock ops, dropout on",
                       fp32_step(dev, MMFiModelConfig(**kw, **FUSED),
                                 xb.float(), yb, hooks=hooks),
                       fp32_step(dev, MMFiModelConfig(**kw), xb.float(), yb,
                                 hooks=hooks), tol)

    # every stage and join launch of the step against its plain version
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    errs = dict.fromkeys(STAGE_ATTRS, 0.0)
    keep = 1.0 - cfg.dropout
    hold_stages(sk, stages, gen, dev, keep, errs, DEFAULT_BATCH)
    hold_joins(sk, joins, gen, dev, keep, errs, DEFAULT_BATCH)
    torch.cuda.synchronize()
    log(f"  the fused MM-Fi step's {len(stages)} stage and {len(joins)} join "
        f"launches each held to their plain versions, each a second launch "
        f"equal bit for bit")

    # one train_pose_model epoch of the fused model on the tree
    model = WiFlowMMFiModel(cfg, device=dev,
                            generator=torch.Generator().manual_seed(SEED))
    res = train_pose_model(*data, Config(train=TrainConfig(
        batch_size=DEFAULT_BATCH, num_epochs=1,
        optim=OptimConfig(weight_decay=1e-4))), model=model,
        connections=MMFI_SKELETON_CONNECTIONS,
        pck_fn=mm.root_relative_pck_fractions, mpe_fn=mm.root_aligned_mpjpe,
        monitor="pck", verbose=False)
    shape = (len(data[2][0]) // (DEFAULT_BATCH // 2) * (DEFAULT_BATCH // 2),
             17, 3)
    if (res.epochs_run != 1 or res.predictions.shape != shape
            or not all(map(math.isfinite, res.test_metrics.values()))):
        raise AssertionError(f"fused MM-Fi train_pose_model: "
                             f"{res.epochs_run} epochs, "
                             f"{res.predictions.shape}, {res.test_metrics}")
    log(f"  train_pose_model, fused MM-Fi model: 1 epoch in "
        f"{res.wall_clock_sec:.2f} s ({res.timings['train_s'][0]:.3f} s of "
        f"training), test {json.dumps(res.test_metrics)}")
    return launches, errs


def mmfi_step_timings(dev, data):
    """Phase 15 (e): the stock-op and the fused MM-Fi step at each of
    ``MMFI_STEP_BATCHES``, in alternating turns, each with the device's
    busy time and events a step."""
    from wiflow_tpu_torch.core.config import (
        MMFI_SKELETON_CONNECTIONS, OptimConfig,
    )
    from wiflow_tpu_torch.metrics import mmfi_metrics as mm
    from wiflow_tpu_torch.models.wiflow_mmfi import MMFiModelConfig
    from wiflow_tpu_torch.train.steps import make_hooks, train_step
    hooks = make_hooks(connections=MMFI_SKELETON_CONNECTIONS,
                       pck_fn=mm.root_relative_pck_fractions,
                       mpe_fn=mm.root_aligned_mpjpe)
    (tx, ty), _, _ = data
    optim = OptimConfig(weight_decay=1e-4)
    for b in MMFI_STEP_BATCHES:
        xb = torch.from_numpy(tx[:b]).to(dev)
        yb = torch.from_numpy(ty[:b]).to(dev)
        states = {"stock": seeded_state(MMFiModelConfig(), dev, optim),
                  "fused": seeded_state(MMFiModelConfig(**FUSED), dev, optim)}
        steps = {n: (lambda st=st: train_step(st, xb, yb, hooks=hooks))
                 for n, st in states.items()}
        turns = {n: [] for n in steps}
        for r in range(STEP_ROUNDS):
            for n in ("fused", "stock")[::1 if r % 2 == 0 else -1]:
                turns[n].append(time_step_ms(steps[n], RUNS // 2))
        for n, ts in turns.items():
            ms = statistics.median(t for t, _ in ts)
            host = statistics.median(h / t for t, h in ts)
            log(f"MM-Fi {n} step bf16 batch {b}, median of {STEP_ROUNDS} "
                f"turns of {RUNS // 2} steps: {ms:.4f} ms = "
                f"{b / ms * 1e3:.1f} frames/s; the host's time to enqueue a "
                f"step {host:.1%} of it; per turn, step / enqueue ms: "
                + " ".join(f"{t:.4f}/{h:.4f}" for t, h in ts))
            profile_step(steps[n], ms, top=8,
                         what=f"MM-Fi {n} step batch {b}")
        del states, steps


def mmfi_kernel_timings(dev, inputs16, train_errs, cli_launches,
                        fused_launches, stage_errs, record):
    """Phase 15 (e): rows 6-13 at the MM-Fi step's shapes, batch
    ``DEFAULT_BATCH``, into the ``mmfi_*`` keys of their record rows."""
    from wiflow_tpu_torch.models.wiflow_mmfi import MMFiModelConfig
    cfg = MMFiModelConfig()
    c, g = cfg.conv_channels[-1], cfg.attention_groups
    log(f"  rows 6-9 at the MM-Fi step's shapes, batch {DEFAULT_BATCH} "
        f"(n={DEFAULT_BATCH * cfg.num_keypoints}, L={cfg.window_size}; "
        f"n={DEFAULT_BATCH * cfg.window_size}, L={cfg.num_keypoints})")
    times = train_kernel_times(inputs16, c, g)
    rows = {r["name"]: r for r in record}
    for name, t in times.items():
        rows[name].update(
            mmfi_launches=cli_launches[name],
            mmfi_max_abs_err=train_errs[name], mmfi_ms=t["ms"],
            mmfi_device_queued_ms=t["device_queued_ms"],
            mmfi_plain_ms=t["plain_ms"], mmfi_bound_ms=t["bound_ms"],
            mmfi_bound_by=t["bound_by"], mmfi_library_ms=t["library_ms"])
    log(f"  rows 10-13 over the launches of one fused MM-Fi step, batch "
        f"{DEFAULT_BATCH}")
    for r in stage_kernel_timings(dev, MMFiModelConfig(**FUSED),
                                  fused_launches, stage_errs,
                                  batch=DEFAULT_BATCH, per_launch=False,
                                  what="MM-Fi "):
        rows[r["name"]].update(
            mmfi_launches=r["launches"], mmfi_max_abs_err=r["max_abs_err"],
            mmfi_ms=r["ms"], mmfi_device_queued_ms=r["device_queued_ms"],
            mmfi_enqueue_ms=r["enqueue_ms"], mmfi_plain_ms=r["plain_ms"],
            mmfi_bound_ms=r["bound_ms"], mmfi_bound_by=r["bound_by"])


def mmfi_training(dev, all_kernels, inputs16, train_errs, record):
    """Phase 15: MM-Fi training on the card, in a temporary directory."""
    log(f"phase 15: MM-Fi training on the card (the MM-Fi CLI, batch "
        f"{DEFAULT_BATCH}, bf16)")
    with tempfile.TemporaryDirectory() as tmp:
        data, cli_launches = mmfi_cli_slice(dev, all_kernels, tmp)
    fused_launches, stage_errs = mmfi_fused_slice(dev, all_kernels, data)
    log("  (e) timings (CUDA events, median of "
        f"{RUNS}, bf16)")
    mmfi_step_timings(dev, data)
    mmfi_kernel_timings(dev, inputs16, train_errs, cli_launches,
                        fused_launches, stage_errs, record)
    torch.cuda.empty_cache()


def ablation_cli(dev, all_kernels):
    """Phase 16 (a): the ablation CLI over the five variants, in this
    process, its launches read."""
    from wiflow_tpu_torch.cli.ablation_demo import VARIANTS
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ablations")
        argv = [*ABLATION_FLAGS, "--output_dir", out]
        log(f"  (a) python -m wiflow_tpu_torch.cli.ablation_demo "
            f"{' '.join(argv)} (its main in this process)")
        reset_launches(all_kernels)
        t0 = time.perf_counter()
        cli_main(argv, "ablation_demo")
        wall = time.perf_counter() - t0
        launches = read_launches(all_kernels)
        with open(os.path.join(out, "ablation_summary.json"),
                  encoding="utf-8") as fd:
            rows = json.load(fd)["rows"]
        with open(os.path.join(out, "ablation_table.md"),
                  encoding="utf-8") as fd:
            table = fd.read()
    names = [v[0] for v in VARIANTS]
    if [r["variant"] for r in rows] != names or \
            table.count("\n") != 2 + len(names):
        raise AssertionError(f"the ablation summary has {rows}, the table "
                             f"{table!r}")
    steps = int(ABLATION_WINDOWS * 0.7) // TRAIN_BATCH
    attn = sum(1 for *_, over in VARIANTS if over.get("use_attention", True))
    expect_launches(f"the ablation CLI ({len(names)} variants x "
                    f"{ABLATION_EPOCHS} epochs x {steps} steps; "
                    f"{attn} with attention)", launches,
                    dict.fromkeys(TRAIN_KERNELS, 2 * steps * ABLATION_EPOCHS
                                  * attn))
    for r, (_, _, over) in zip(rows, VARIANTS):
        params = sum(p.numel() for p in WiFlowPoseModel(
            ModelConfig(**over), device=dev).parameters())
        if r["params"] != params:
            raise AssertionError(f"{r['variant']}: the CLI counts "
                                 f"{r['params']} parameters, the module "
                                 f"{params}")
        log(f"  {r['variant']}: {r['params']} parameters, epoch "
            f"{r['epoch_s']:.3f} s, step {r['step_ms']:.4f} ms, test PCK@10 "
            f"{r['pck10']}%, PCK@20 {r['pck20']}%, MPJPE {r['mpjpe_m']} m")
    log(f"  the ablation CLI ran in {wall:.2f} s and wrote the summary and "
        f"the table of {len(rows)} variants")
    SUMMARY.append("ablation steps ms " + ", ".join(
        f"{r['variant']} {r['step_ms']:.2f}" for r in rows))


def ablation_steps(dev, all_kernels, xb, yb):
    """Phase 16 (b): one bf16 train step of each variant, its launches."""
    from wiflow_tpu_torch.cli.ablation_demo import VARIANTS
    from wiflow_tpu_torch.core.config import ModelConfig, OptimConfig
    from wiflow_tpu_torch.train.steps import create_train_state, train_step
    for name, _, over in VARIANTS:
        cfg = ModelConfig(**over)
        st = create_train_state(cfg, OptimConfig(), seed=SEED, device=dev)
        reset_launches(all_kernels)
        m = train_step(st, xb, yb)
        expect_launches(f"one {name} train step", read_launches(all_kernels),
                        dict.fromkeys(TRAIN_KERNELS,
                                      2 if cfg.use_attention else 0))
        if not math.isfinite(m["loss"].item()):
            raise AssertionError(f"{name}: the loss is not finite")
        log(f"  {name}: {sum(p.numel() for p in st.model.parameters())} "
            f"parameters, loss {m['loss'].item():.6f}")
        del st


def tcn_geometry_timings(sk, cases, gen, dev, keep):
    """Phase 16 (d): each distinct new geometry alone, bf16."""
    dt = torch.bfloat16
    for c in {case_label(c): c for c in cases}.values():
        i = stage_inputs(c, gen, dev, keep)
        x, go = i["x"].to(dt), i["go"].to(dt)
        args = (i["m"], i["a"], i["b"], i["mask"], i["w"], i["bias"])
        kw = dict(kind=c["kind"], dil=c["dil"], keep=keep)
        out, _ = sk.stage_forward(x, *args, **kw)

        def fwd():
            return sk.stage_forward(x, *args, **kw)

        def bwd():
            return sk.stage_backward(x, *args[:5], out, go, i["gs"],
                                     has_bias=c["bias"],
                                     need_gx=c["need_gx"], **kw)

        (wf, wb) = stage_work(c, 2)
        bf, byf = bound_ms(*wf, dt)
        bb, byb = bound_ms(*wb, dt)
        plain = time_ms(lambda: sk.stage_plain(x, *args, **kw),
                        max(3, RUNS // 4))
        log(f"    {case_label(c)}: fwd {time_ms(fwd, RUNS):.4f} ms (queued "
            f"{queued_ms(fwd):.4f}), plain {plain:.4f}, bound {bf:.4f} "
            f"({byf}); bwd {time_ms(bwd, RUNS):.4f} ms (queued "
            f"{queued_ms(bwd):.4f}), bound {bb:.4f} ({byb})")


@contextlib.contextmanager
def replayed_masks(masks, replay):
    """Dropout keep-masks (``ops/norm.py::_keep_mask``) recorded into
    ``masks`` in the order a step draws them, or, with ``replay``, handed
    out again from it, on any device: a step on the CPU then drops what
    the same step on the card dropped."""
    from wiflow_tpu_torch.ops import norm
    inner, it = norm._keep_mask, iter(masks)

    def keep(shape, keep_p, device, generator):
        if replay:
            m = next(it)
            if tuple(m.shape) != tuple(shape):
                raise AssertionError(f"replayed mask {tuple(m.shape)} for "
                                     f"{tuple(shape)}")
            return m.to(device)
        m = inner(shape, keep_p, device, generator)
        masks.append(m.cpu())
        return m

    norm._keep_mask = keep
    try:
        yield
    finally:
        norm._keep_mask = inner
    if replay and next(it, None) is not None:
        raise AssertionError("the replayed step drew fewer masks")


@contextlib.contextmanager
def float64_moments():
    """Train-mode BatchNorm with its moments in the input's dtype: the
    port's ``batch_norm_train`` takes them in fp32 whatever the input, so
    a float64 step needs this to be float64 throughout its BatchNorms."""
    from wiflow_tpu_torch.models import layers
    from wiflow_tpu_torch.ops.norm import EPS, running_update
    inner = layers.batch_norm_train

    def bn(x, gamma, beta, running_mean, running_var):
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(dim=axes)
        var = (x * x).mean(dim=axes) - mean * mean
        a = (gamma * torch.rsqrt(var + EPS)).to(x.dtype)
        new_mean, new_var = running_update(
            running_mean, running_var, mean.detach(), var.detach(),
            x.numel() // x.shape[-1])
        return (x - mean) * a + beta.to(x.dtype), new_mean, new_var

    layers.batch_norm_train = bn
    try:
        yield
    finally:
        layers.batch_norm_train = inner


def tcn_variants(dev, all_kernels, xb, yb, record):
    """Phase 16 (c) and (d): ``tcn_conv`` ``plain`` and ``depthwise`` under
    the fused switches."""
    from wiflow_tpu_torch.core.config import ModelConfig, OptimConfig
    from wiflow_tpu_torch.ops.kernels import stage_fused as sk
    from wiflow_tpu_torch.train.steps import create_train_state, train_step
    rows = {r["name"]: r for r in record}
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    xb32 = xb.float()
    for v in TCN_VARIANTS:
        cfg = ModelConfig(tcn_conv=v, **FUSED)
        keep = 1.0 - cfg.dropout
        cases = [c for b in (TRAIN_BATCH, 7)
                 for c in sk.step_launches(cfg, b)[0]
                 if c["kind"] == "causal3"]
        log(f"  (c) tcn_conv={v!r}: the {len(cases)} causal3 stages of a step "
            f"at batch {TRAIN_BATCH} and 7, each with its plan (forward / "
            f"input gradient / weight gradient: path, groups a block, shared "
            f"memory) in bf16 and fp32")
        for c in cases:
            g = sk.stage_geometry(c["kind"], c["lead"], c["ci"], c["co"],
                                  c["groups"], c["dil"])
            plans = [sk.stage_plan(g, dt) for dt in (torch.bfloat16,
                                                     torch.float32)]
            log(f"    {case_label(c)}: " + "; ".join(
                f"{name} " + " / ".join(
                    f"{p.path} gpb {getattr(p, 'gpb', '-')} smem {p.smem}"
                    for p in (pl.fwd, pl.dgrad, pl.wgrad))
                for name, pl in zip(("bf16", "fp32"), plans)))
        errs = dict.fromkeys(STAGE_ATTRS, 0.0)
        hold_stages(sk, cases, gen, dev, keep, errs, TRAIN_BATCH)
        # the fused bf16 step: its launches
        st = create_train_state(cfg, OptimConfig(), seed=SEED, device=dev)
        stages, joins = sk.step_launches(cfg, TRAIN_BATCH)
        reset_launches(all_kernels)
        train_step(st, xb, yb)
        launches = read_launches(all_kernels)
        expect_launches(f"one fused {v} train step", launches, {
            **dict.fromkeys(TRAIN_KERNELS, 2),
            "stage_fwd": len(stages), "stage_bwd": len(stages),
            "join_fwd": len(joins), "join_bwd": len(joins)})
        del st
        # one fp32 step with dropout on, fused vs stock ops, held to 4x the
        # stock-op step's fp32 noise: its distance to the same step in
        # float64 on the CPU (the card's dropout masks replayed there).
        # The flagship's phase 9 holds twice its noise; here the fused
        # step's own distance to float64 is ~3x the stock-op step's (its
        # fp32 sums over the dense TCN convs are blocked otherwise), so
        # |fused - stock| <= |fused - ref| + |stock - ref| needs 4x.  A
        # fault of a kernel or of the wiring shows as errors of order 1.
        kw = dict(tcn_conv=v, compute_dtype="float32")
        masks = []
        with replayed_masks(masks, replay=False):
            stock = fp32_step(dev, ModelConfig(**kw), xb32, yb)
        fused = fp32_step(dev, ModelConfig(**kw, **FUSED), xb32, yb)
        with replayed_masks(masks, replay=True), float64_moments():
            ref = fp32_step("cpu", ModelConfig(tcn_conv=v,
                                               compute_dtype="float64"),
                            xb32.double(), yb)

        def dist(got):
            return max(leaf_noise(got[1], ref[1], GRAD_FLOOR),
                       leaf_noise(got[2], ref[2], STAT_FLOOR),
                       leaf_noise({"g": got[0]["grad_norm"]},
                                  {"g": ref[0]["grad_norm"]}, 0.0))

        noise = dist(stock)
        tol = max(TOL_F32, 4.0 * noise)
        log(f"  fp32 rounding noise of one {v} step, dropout on (its distance "
            f"to the float64 step on the CPU, {len(masks)} masks replayed): "
            f"{noise:.3e} (the fused step's {dist(fused):.3e}); the fused "
            f"step is held to {tol:.3e}")
        compare_fp32_steps(f"{v} fused vs stock ops, dropout on", fused,
                           stock, tol)
        log(f"  (d) tcn_conv={v!r}: each new geometry alone, bf16, batch "
            f"{TRAIN_BATCH} (CUDA events, median of {RUNS}; queued behind a "
            f"spin)")
        tcn_geometry_timings(sk, [c for c in cases
                                  if c["lead"][0] == TRAIN_BATCH],
                             gen, dev, keep)
        for r in stage_kernel_timings(dev, cfg, launches, errs,
                                      per_launch=False, what=f"{v} "):
            rows[r["name"]].update({
                f"tcn_{v}_{k}": r[k] for k in (
                    "launches", "max_abs_err", "ms", "device_queued_ms",
                    "plain_ms", "bound_ms", "bound_by")})
        torch.cuda.empty_cache()


def ablation_slice(dev, all_kernels, record):
    """Phase 16: the ablation switches on the card."""
    from wiflow_tpu_torch.core.config import ModelConfig
    log(f"phase 16: the ablations on the card (default ModelConfig at full "
        f"width, bf16, batch {TRAIN_BATCH})")
    ablation_cli(dev, all_kernels)
    xs, ys = train_data(dev, ModelConfig())
    xb, yb = xs[:TRAIN_BATCH], ys[:TRAIN_BATCH]
    log("  (b) one bf16 train step of each variant")
    ablation_steps(dev, all_kernels, xb, yb)
    tcn_variants(dev, all_kernels, xb, yb, record)
    del xs, ys, xb, yb
    torch.cuda.empty_cache()


def done_line(text):
    """The ``[done]`` line a CLI run printed."""
    lines = [ln for ln in text.splitlines() if ln.startswith("[done]")]
    if len(lines) != 1 or "nan" in lines[0].lower():
        raise AssertionError(f"the run's [done] lines: {lines}")
    return lines[0]


def model_size(dev, name):
    """A baseline's parameters, and its FLOPs a window with the FLOPs of
    its resizes as the JAX package's count has them."""
    from wiflow_tpu_torch.cli.run_baseline import build_model
    from wiflow_tpu_torch.utils.flops import (
        count_params, flop_count, resize_flops,
    )
    model = build_model(name, device=dev)
    x1 = torch.zeros((1, 540, 20), device=dev)
    return count_params(model), flop_count(model, x1), resize_flops(model,
                                                                    x1)


def baseline_runs(dev, all_kernels, tmp):
    """Phase 17 (a): ``run_baseline`` for each baseline, and ``hpeli``'s
    resume held to the run never stopped."""
    from wiflow_tpu_torch.data.synthetic import make_preprocessed_dataset
    # the CLI's --synthetic files (20), cut to BASELINE_FRAMES frames each:
    # --synthetic finds them and makes none
    data = make_preprocessed_dataset(tmp, num_files=20,
                                     frames_per_file=BASELINE_FRAMES)
    flags = ["--synthetic", "--data_dir", data, *BASELINE_FLAGS]
    for name in BASELINES:
        argv = ["--model", name, *flags, "--output_dir",
                os.path.join(tmp, name)]
        log(f"  (a) python -m wiflow_tpu_torch.cli.run_baseline "
            f"{' '.join(argv)} (its main in this process)")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches(all_kernels)
        text = cli_main(argv, "run_baseline")
        expect_launches(f"run_baseline {name}", read_launches(all_kernels),
                        {})
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        t = run_timings(text)
        windows = int(re.search(r"\[split\] train: (\d+)", text).group(1))
        batch = min(DEFAULT_BATCH, windows)
        steps = windows // batch
        params, flops, extra = model_size(dev, name)
        log(f"  {name}: {done_line(text)}; epoch {t['epoch_s'][0]:.3f} s, "
            f"step {1e3 * t['train_s'][0] / steps:.4f} ms, "
            f"{steps * batch / t['train_s'][0]:.1f} training windows/s, "
            f"peak memory {peak:.3f} GiB, {params} parameters, "
            f"{flops / 1e9:.4f} GFLOP a window (the JAX count adds "
            f"{extra / 1e9:.4f} G of resizes)")
        if not os.path.exists(os.path.join(tmp, name,
                                           "best_pose_model.msgpack")):
            raise AssertionError(f"{name}: no best_pose_model.msgpack")
    hp = ["--model", "hpeli", "--synthetic", "--data_dir", data,
          "--batch_size", str(DEFAULT_BATCH), "--epochs", "2"]
    text = cli_main([*hp, "--output_dir", os.path.join(tmp, "hpeli")],
                    "run_baseline")
    if "[resume] continuing from epoch 2 of 2" not in text:
        raise AssertionError("hpeli did not resume at epoch 2")
    cli_main([*hp, "--output_dir", os.path.join(tmp, "hpeli2")],
             "run_baseline")
    if not same_run(os.path.join(tmp, "hpeli"), os.path.join(tmp, "hpeli2")):
        raise AssertionError("hpeli resumed to 2 epochs differs from the run "
                             "never stopped")
    log("  hpeli resumed to 2 epochs equals the 2-epoch run never stopped, "
        "history and final weights bit for bit")
    SUMMARY.append("hpeli resume bit-equal")


def baseline_mmfi_runs(dev, all_kernels, tmp):
    """Phase 17 (b): ``run_mmfi --model`` each baseline on phase 15's
    tree, made again with ``BASELINE_MMFI_SUBJECTS``."""
    from wiflow_tpu_torch.data.mmfi import (
        FRAMES_PER_SEQUENCE, generate_synthetic_mmfi,
    )
    tree = os.path.join(tmp, "MMFi")
    generate_synthetic_mmfi(tree, subjects=BASELINE_MMFI_SUBJECTS,
                            actions=MMFI_ACTIONS, frames=FRAMES_PER_SEQUENCE,
                            fmt="npy", learnable=True)
    for name in BASELINES:
        argv = ["--model", name, "--dataset_root", tree, "--output_dir",
                os.path.join(tmp, f"mmfi_{name}"), "--epochs", "1",
                *MMFI_CLI_FLAGS]
        log(f"  (b) python -m wiflow_tpu_torch.cli.run_mmfi {' '.join(argv)} "
            f"(its main in this process)")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches(all_kernels)
        text = cli_main(argv, "run_mmfi")
        expect_launches(f"run_mmfi --model {name}",
                        read_launches(all_kernels), {})
        t = run_timings(text)
        frames = int(re.search(r"\[split\] train (\d+)", text).group(1))
        batch = min(DEFAULT_BATCH, frames)
        steps = frames // batch
        log(f"  MM-Fi {name}: {done_line(text)}; step "
            f"{1e3 * t['train_s'][0] / steps:.4f} ms, "
            f"{steps * batch / t['train_s'][0]:.1f} training frames/s, peak "
            f"memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB")


def baseline_table_run(dev, all_kernels, tmp):
    """Phase 17 (c): the comparison table over the five models."""
    out = os.path.join(tmp, "table")
    argv = ["--windows", str(TABLE_WINDOWS), "--epochs", "1",
            "--batch_size", str(DEFAULT_BATCH), "--output_dir", out]
    log(f"  (c) python -m wiflow_tpu_torch.cli.baseline_table "
        f"{' '.join(argv)} (its main in this process; no --per_model_batch: "
        f"every model fits batch {DEFAULT_BATCH})")
    torch.cuda.empty_cache()
    reset_launches(all_kernels)
    cli_main(argv, "baseline_table")
    launches = read_launches(all_kernels)
    n_tr = int(TABLE_WINDOWS * 0.7)
    steps = n_tr // min(DEFAULT_BATCH, n_tr)
    expect_launches(f"the comparison table (the wiflow row's {steps} steps)",
                    launches, dict.fromkeys(TRAIN_KERNELS, 2 * steps))
    with open(os.path.join(out, "comparison_summary.json"),
              encoding="utf-8") as fd:
        rows = json.load(fd)["rows"]
    if [r["model"] for r in rows] != ["wiflow", *BASELINES]:
        raise AssertionError(f"the table's rows: {[r['model'] for r in rows]}")
    for r in rows:
        if not r["flops_g"] or not math.isfinite(r["mpjpe_m"]):
            raise AssertionError(f"table row {r}")
        log(f"  table {r['model']}: step {r['step_ms']:.4f} ms, "
            f"{r['windows_per_s']:.1f} windows/s, peak memory "
            f"{r['peak_mem_gb']:.3f} GiB, {r['params_m']} M parameters, "
            f"{r['flops_g']} GFLOP a window; test PCK@20 {r['pck20']}%, "
            f"MPJPE {r['mpjpe_m']} m ({r['flops_note']})")
    SUMMARY.append("table step ms " + ", ".join(
        f"{r['model']} {r['step_ms']:.2f}" for r in rows))


def baseline_slice(dev, all_kernels):
    """Phase 17: the four baselines through their CLIs, the MM-Fi CLI and
    the comparison table, in a temporary directory."""
    log(f"phase 17: the baselines on the card, published widths, bf16, "
        f"batch {DEFAULT_BATCH}")
    with tempfile.TemporaryDirectory() as tmp:
        baseline_runs(dev, all_kernels, tmp)
        baseline_mmfi_runs(dev, all_kernels, tmp)
        baseline_table_run(dev, all_kernels, tmp)
    torch.cuda.empty_cache()

def zoo_model(name, device, stages=5, dtype="bfloat16"):
    """A robustness model as ``cli/run_robustness.py`` builds it (seed
    ``SEED``); ``denoiser_hpe`` with ``stages`` and ``dtype``."""
    from wiflow_tpu_torch.cli.run_robustness import build_model
    from wiflow_tpu_torch.robustness import DenoiserHPE
    if name == "denoiser_hpe":
        return DenoiserHPE(stages, compute_dtype=dtype, device=device,
                           generator=torch.Generator().manual_seed(SEED))
    return build_model(name, device=device, seed=SEED)


def zoo_batch(name, batch, dev):
    """Random CSI of the model's dataset and keypoints with a unit
    confidence column, on the card."""
    k, shape = (18, (9, 30, 5)) if "wipose" in name else (17, (3, 114, 10))
    g = torch.Generator(device=dev).manual_seed(SEED + batch)
    x = torch.randn((batch, *shape), generator=g, device=dev)
    y = torch.cat([0.1 * torch.randn((batch, k, 2), generator=g, device=dev),
                   torch.ones((batch, k, 1), device=dev)], dim=-1)
    return x, y


@torch.no_grad()
def zoo_on_card(dev):
    """Phase 18 (a)-(c): each model on the card against the port on the
    CPU from the same weights (fp32, TF32 off), DenoiserHPE in bf16 against
    fp32, MultiAxisAttention and its antialiased resize, and the torch
    noise functions' statistics."""
    from wiflow_tpu_torch.models.baselines.sknet_trans import (
        MultiAxisAttention, resize_rows,
    )
    from wiflow_tpu_torch.robustness import (
        add_awgn_torch, add_salt_and_pepper_torch,
    )
    cases = [(n, 5) for n in ROBUST_MODELS[:-1]] + [("denoiser_hpe", 1),
                                                    ("denoiser_hpe", 5)]
    for name, stages in cases:
        cpu = zoo_model(name, "cpu", stages, "float32")
        nontrivial_stats(cpu)
        card = zoo_model(name, dev, stages, "float32")
        card.load_state_dict(cpu.state_dict())
        x, _ = zoo_batch(name, 16, dev)
        ref = cpu(x.cpu())
        got = card(x)
        err = compare(f"{name} ({stages} stages)" if name == "denoiser_hpe"
                      else name, got.cpu(), ref, TOL_F32)
        log(f"  (a) {name}{f' {stages} stages' if stages != 5 else ''}: "
            f"card vs CPU fp32 {err:.3e} x max|ref|")
        if name == "denoiser_hpe":
            bf = zoo_model(name, dev, stages, "bfloat16")
            bf.load_state_dict(cpu.state_dict())
            err = compare(f"denoiser_hpe {stages} bf16", bf(x), got, TOL_BF16)
            log(f"  (a) denoiser_hpe {stages} stages: bf16 vs fp32 on the "
                f"card {err:.3e} x max|ref|")
    gen = torch.Generator().manual_seed(SEED)
    cpu = MultiAxisAttention(3, 64, depth=1, device="cpu", generator=gen)
    nontrivial_stats(cpu)
    card = MultiAxisAttention(3, 64, depth=1, device=dev,
                              generator=torch.Generator())
    card.load_state_dict(cpu.state_dict())
    card.eval()
    cpu.eval()
    x = torch.randn((16, 114, 10, 3), generator=gen)
    err = compare("MultiAxisAttention", card(x.to(dev)).cpu(), cpu(x),
                  TOL_F32)
    rows = torch.randn((16, 114, 10, 64), generator=gen)
    err2 = compare("resize 114 -> 32 rows", resize_rows(rows.to(dev),
                                                        32).cpu(),
                   resize_rows(rows, 32), TOL_F32)
    log(f"  (b) MultiAxisAttention card vs CPU {err:.3e}, its antialiased "
        f"resize 114 -> 32 rows {err2:.3e} x max|ref|")
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((256, 3, 114, 10), generator=g, device=dev)
    std = ((add_awgn_torch(x, 0.1, g) - x).std() / (x.max() - x.min()))
    flat = torch.full((256, 3, 114, 10), 0.5, device=dev)
    sp = add_salt_and_pepper_torch(flat, 0.2, g)
    ones, zeros = (sp == 1).float().mean(), (sp == 0).float().mean()
    log(f"  (c) on the card: AWGN std / range {std.item():.5f} (0.1), "
        f"salt {ones.item():.5f} and pepper {zeros.item():.5f} (0.1 each)")
    if not (abs(std.item() - 0.1) < 2e-3 and abs(ones.item() - 0.1) < 2e-3
            and abs(zeros.item() - 0.1) < 2e-3):
        raise AssertionError("the torch noise functions' statistics")


def zoo_step_times(dev):
    """Phase 18 (d): each model's train step (SGD, the CLI's loss and
    hooks) at the CLI's batch and at the train step's."""
    from wiflow_tpu_torch.cli.run_robustness import (
        conf_weighted_mse, to_xy_keypoints,
    )
    from wiflow_tpu_torch.core.config import OptimConfig
    from wiflow_tpu_torch.metrics.metrics import pckh_fractions_fn
    from wiflow_tpu_torch.train.steps import (
        create_train_state, make_hooks, train_step,
    )
    optim = OptimConfig(lr=1e-3, kind="sgd", momentum=0.0,
                        grad_clip_norm=None, schedule="linear_decay")
    times = {}
    for name in ROBUST_MODELS:
        pck = pckh_fractions_fn(*((6, 13) if "wipose" in name else (1, 11)))
        hooks = make_hooks(loss_fn=conf_weighted_mse,
                           to_keypoints=to_xy_keypoints, pck_fn=pck)
        for batch in ROBUST_BATCHES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            state = create_train_state(optim=optim,
                                       model=zoo_model(name, dev))
            x, y = zoo_batch(name, batch, dev)
            for _ in range(3):
                train_step(state, x, y, hooks=hooks)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ROBUST_STEPS):
                m = train_step(state, x, y, hooks=hooks)
            loss = m["loss"].item()
            ms = 1e3 * (time.perf_counter() - t0) / ROBUST_STEPS
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if not math.isfinite(loss):
                raise AssertionError(f"{name} batch {batch}: loss {loss}")
            times[(name, batch)] = ms
            log(f"  (d) {name} batch {batch}: step {ms:.4f} ms, "
                f"{batch * 1e3 / ms:.1f} windows/s, peak memory "
                f"{peak:.3f} GiB ({ROBUST_STEPS} steps, host clock ending "
                f"in a sync)")
            del state
    batches = "/".join(map(str, ROBUST_BATCHES))
    SUMMARY.append(f"zoo step ms at batch {batches} " + ", ".join(
        n + " " + "/".join(f"{times[(n, b)]:.2f}" for b in ROBUST_BATCHES)
        for n in ROBUST_MODELS))


def greedy_denoiser(dev):
    """Phase 18 (e): the AE's 5 greedy stages at MM-Fi's shape, each
    frozen prefix unchanged bit for bit."""
    from wiflow_tpu_torch.robustness import add_awgn_torch
    from wiflow_tpu_torch.robustness import train_denoiser_stage
    g = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.rand((AE_WINDOWS, 3, 114, 10), generator=g, device=dev)
    prev, secs = None, []
    for stage in range(1, 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd = train_denoiser_stage(
            data, stage, lambda x, gen: add_awgn_torch(x, 0.1, gen),
            prev_state_dict=prev, epochs=1, batch_size=32, seed=SEED,
            verbose=True, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        for k, v in (prev or {}).items():
            if not torch.equal(sd[k], v):
                raise AssertionError(f"stage {stage} moved its frozen {k}")
        log(f"  (e) AE stage {stage}: 1 epoch of {AE_WINDOWS // 32} steps "
            f"(batch 32) in {secs[-1]:.4f} s"
            + (f"; the {stage - 1}-stage prefix bit-equal" if prev else ""))
        prev = sd
    SUMMARY.append("AE stage epoch s " + "/".join(f"{t:.2f}" for t in secs))


def robustness_clis(dev, all_kernels, tmp):
    """Phase 18 (f): ``cli/run_robustness.py`` in modes 0, 1 and 2 on the
    learnable MM-Fi tree, DSKNetTrans on synthetic WiPose, and
    ``cli/robustness_demo.py`` at one level; no kernel of the repository
    is on their paths."""
    tree = os.path.join(tmp, "mmfi")
    runs = [
        ("mode 0", ["--model", "original_hpe", "--mode", "0"]),
        ("mode 1", ["--model", "denoiser_hpe", "--denoiser_stages", "2",
                    "--denoiser_epochs", "2", "--noise_levels", "0.1"]),
        ("mode 2", ["--model", "original_hpe", "--mode", "2", "--filter",
                    "gaussian", "--noise_levels", "0.1"]),
        ("WiPose", ["--model", "dsknet_trans_wipose", "--wipose_root",
                    os.path.join(tmp, "wipose")]),
    ]
    for i, (what, flags) in enumerate(runs):
        argv = [*flags, *ROBUST_CLI, "--dataset_root", tree, "--output_dir",
                os.path.join(tmp, f"run{i}")]
        log(f"  (f) python -m wiflow_tpu_torch.cli.run_robustness "
            f"{' '.join(argv)} (its main in this process)")
        reset_launches(all_kernels)
        t0 = time.perf_counter()
        text = cli_main(argv, "run_robustness")
        wall = time.perf_counter() - t0
        expect_launches(f"run_robustness {what}", read_launches(all_kernels),
                        {})
        path = done_line(text).split("-> ")[1]
        with open(path, encoding="utf-8") as fd:
            res = json.load(fd)
        for level, row in res.items():
            vals = [row["test_pck20"], row["test_mpjpe"]] + [
                v for r in row["sweep"].values() for v in r.values()]
            if not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"{what}: {row}")
            log(f"  {what} level {level}: test PCK@20 "
                f"{100 * row['test_pck20']:.2f}%, MPJPE "
                f"{row['test_mpjpe']:.4f}, sweep " + ", ".join(
                    f"{k}: PCK@20 {100 * r['pck@0.2']:.2f}%"
                    for k, r in row["sweep"].items()))
        t = run_timings(text)
        log(f"  {what}: run {wall:.3f} s, epochs "
            + ", ".join(f"{e:.3f}" for e in t["epoch_s"]) + " s")
        filt = [ln for ln in text.splitlines()
                if ln.startswith("[filter] gaussian train:")]
        if what == "mode 2":
            if len(filt) != 1:
                raise AssertionError(f"mode 2 printed {filt}")
            SUMMARY.append("mode 2 " + filt[0][1:].replace("]", ""))
    argv = ["--epochs", "2", "--levels", "0.1", "--denoiser_stages", "2",
            "--denoiser_epochs", "1", "--synthetic_frames", "100",
            "--work_dir", os.path.join(tmp, "demo_work"), "--dataset_root",
            os.path.join(tmp, "demo_mmfi"), "--output_dir",
            os.path.join(tmp, "demo")]
    log(f"  (f) python -m wiflow_tpu_torch.cli.robustness_demo "
        f"{' '.join(argv)} (its main in this process)")
    reset_launches(all_kernels)
    t0 = time.perf_counter()
    cli_main(argv, "robustness_demo")
    expect_launches("robustness_demo", read_launches(all_kernels), {})
    with open(os.path.join(tmp, "demo", "summary.json"),
              encoding="utf-8") as fd:
        rows = json.load(fd)["table"]["levels"]["0.1"]
    log(f"  demo: {time.perf_counter() - t0:.3f} s; at 0.1 PCK@20 "
        + ", ".join(f"{k} {r['pck20']:.2f}%" for k, r in rows.items()))


@torch.no_grad()
def flagship_sweep(dev, all_kernels, trained):
    """Phase 18 (g): ``evaluate_robustness`` over the flagship's
    ``fast_forward`` (bf16) serving the weights phase 14's CLI trained, on
    the CLI's test split against its true keypoints, at the kit's default
    levels (0.0, 0.1, 0.2, 0.4; AWGN, no cleaner): level 0.0 equals the
    same predictions evaluated directly, PCK@20 at 0.4 is below PCK@20 at
    0.0, and rows 1-3 are launched for every batch."""
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.metrics.metrics import mpjpe, pck_correct_fractions
    from wiflow_tpu_torch.metrics.mmfi_metrics import pa_mpjpe
    from wiflow_tpu_torch.models.fast import fast_forward, pack_fast
    from wiflow_tpu_torch.robustness import evaluate_robustness
    from wiflow_tpu_torch.robustness.evaluate import THRESHOLDS
    sd, (csi, kp) = trained
    packed = pack_fast(sd, ModelConfig(), device=dev)
    batch = SWEEP_BATCH
    nb = len(csi) // batch
    levels = (0.0, 0.1, 0.2, 0.4)
    reset_launches(all_kernels)
    t0 = time.perf_counter()
    res = evaluate_robustness(lambda x: fast_forward(packed, x), csi, kp,
                              noise_levels=levels, batch_size=batch,
                              seed=SEED, device=dev)
    wall = time.perf_counter() - t0
    expect_launches(f"evaluate_robustness over fast_forward, {len(levels)} "
                    f"levels", read_launches(all_kernels),
                    {"tcn_level": 4 * nb * len(levels),
                     "conv_stack": nb * len(levels),
                     "axial_attention": 2 * nb * len(levels)})
    pred = torch.cat([fast_forward(packed, torch.from_numpy(
        csi[i:i + batch]).to(dev)) for i in range(0, nb * batch, batch)])
    target = torch.from_numpy(kp[:len(pred)]).to(dev)
    direct = {f"pck@{t}": float(v) for t, v in zip(
        THRESHOLDS, pck_correct_fractions(pred, target, THRESHOLDS).tolist())}
    direct["mpjpe"] = float(mpjpe(pred, target))
    direct["pa_mpjpe"] = float(pa_mpjpe(pred, target))
    if res[0.0] != direct:
        raise AssertionError(f"level 0.0 {res[0.0]} != the direct "
                             f"evaluation {direct}")
    log(f"  (g) evaluate_robustness over fast_forward of phase 14's trained "
        f"weights, the CLI's test split ({nb * batch} of {len(csi)} windows,"
        f" batch {batch}), AWGN, true keypoints: {wall:.4f} s for "
        f"{len(levels)} levels; level 0.0 equals the direct evaluation")
    for lv in levels:
        log(f"      level {lv}: PCK@20 {100 * res[lv]['pck@0.2']:.2f}%, "
            f"PCK@50 {100 * res[lv]['pck@0.5']:.2f}%, MPJPE "
            f"{res[lv]['mpjpe']:.5f}, PA-MPJPE {res[lv]['pa_mpjpe']:.5f}")
    if not res[0.4]["pck@0.2"] < res[0.0]["pck@0.2"]:
        raise AssertionError(f"PCK@20 does not fall with the noise: "
                             f"{res[0.0]['pck@0.2']} at 0.0, "
                             f"{res[0.4]['pck@0.2']} at 0.4")
    SUMMARY.append("sweep PCK@20 " + " / ".join(
        f"{100 * res[lv]['pck@0.2']:.2f}" for lv in levels)
        + f" % at levels {levels}")


def robustness_slice(dev, all_kernels, trained):
    """Phase 18: the robustness kit on the card; ``trained`` is phase 14's
    best weights and test split, which the sweep serves."""
    log("phase 18: the robustness kit on the card (HPE-Li's zoo, the "
        "denoising AEs, the robustness CLIs, the flagship swept)")
    t0 = time.perf_counter()
    zoo_on_card(dev)
    zoo_step_times(dev)
    greedy_denoiser(dev)
    with tempfile.TemporaryDirectory() as tmp:
        robustness_clis(dev, all_kernels, tmp)
    flagship_sweep(dev, all_kernels, trained)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"  phase 18: {wall:.1f} s")
    SUMMARY.append(f"phase 18 {wall:.1f} s")


def demo_slice(dev, all_kernels):
    """Phase 19: the demo CLIs on the card, cut in windows and epochs,
    never widths: ``convergence_demo`` (in this process, its train
    kernels counted), ``kill_resume_demo`` (its runs are subprocesses:
    killed after epoch 2's bundle, resumed at epoch 3, the histories held
    together at the JAX demo's tolerance) and ``loso_demo`` (5 folds, in
    this process)."""
    log("phase 19: the demo CLIs on the card")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "convergence")
        argv = ["--windows", str(DEMO_WINDOWS), "--epochs", str(DEMO_EPOCHS),
                "--batch_size", str(TRAIN_BATCH), "--no_videos",
                "--output_dir", out]
        reset_launches(all_kernels)
        with watched_steps(all_kernels, augmented=False) as seen:
            text = cli_main(argv, "convergence_demo")
        steps = seen["steps"]
        expect_launches(f"convergence_demo ({steps} steps)",
                        read_launches(all_kernels),
                        {n: 2 * steps for n in TRAIN_KERNELS})
        with open(os.path.join(out, "run_summary.json")) as f:
            summary = json.load(f)
        n_train = int(DEMO_WINDOWS * 0.7)
        if summary["epochs_run"] != DEMO_EPOCHS or "[done]" not in text \
                or steps != DEMO_EPOCHS * (n_train // TRAIN_BATCH):
            raise AssertionError(f"convergence_demo: {summary}")
        if not all(math.isfinite(v) for v in summary["test_metrics"].values()):
            raise AssertionError(
                f"convergence_demo: {summary['test_metrics']}")
        rate = n_train * DEMO_EPOCHS / summary["train_wall_clock_sec"]
        log(f"  convergence_demo summary: {json.dumps(summary)}")
        log(f"  convergence_demo: {DEMO_EPOCHS} epochs of {n_train} windows "
            f"in {summary['train_wall_clock_sec']} s (train_wall_clock_sec, "
            f"validation and test included) = {rate:.1f} windows/s; data "
            f"made on the card in {summary['data_gen_sec']} s")

        kr = os.path.join(tmp, "kill_resume")
        cli_main(["--windows", str(KILL_WINDOWS), "--epochs",
                  str(KILL_EPOCHS), "--kill_epoch", str(KILL_EPOCH),
                  "--output_dir", kr], "kill_resume_demo")
        with open(os.path.join(kr, "kill_resume_summary.json")) as f:
            krs = json.load(f)
        cmp_ = krs["history_compare"]
        if not cmp_["identical_within_tol"] or \
                cmp_["epochs_compared"] != KILL_EPOCHS:
            raise AssertionError(f"kill/resume: {cmp_}")
        if f"continuing from epoch {KILL_EPOCH + 1} " not in \
                krs["run_b"]["resume_line"]:
            raise AssertionError(f"kill/resume: {krs['run_b']}")
        log(f"  kill_resume_demo: killed mid-epoch {KILL_EPOCH + 1}, "
            f"{krs['run_b']['resume_line']!r}; {cmp_['epochs_compared']} "
            f"epochs compared, identical within tolerance, max_abs_diff "
            f"{cmp_['max_abs_diff']:.3e}")

        lo = os.path.join(tmp, "loso")
        reset_launches(all_kernels)
        cli_main(["--per_subject", str(LOSO_PER_SUBJECT), "--epochs",
                  str(LOSO_EPOCHS), "--output_dir", lo], "loso_demo")
        launches = read_launches(all_kernels)
        if not all(launches[n] for n in TRAIN_KERNELS):
            raise AssertionError(f"loso_demo launched {launches}")
        with open(os.path.join(lo, "loso_summary.json")) as f:
            ls = json.load(f)
        with open(os.path.join(lo, "loso_table.md")) as f:
            rows = f.read().splitlines()[2:]
        if [r["subject"] for r in ls["folds"]] != [1, 2, 3, 4, 5] or \
                len(rows) != 6:
            raise AssertionError(f"loso_demo: {ls}")
        log(f"  loso_demo: 5 folds, launches {json.dumps(launches)}; "
            f"average {json.dumps(ls['average'])}")
    wall = time.perf_counter() - t0
    log(f"  phase 19: {wall:.1f} s")
    SUMMARY.append(f"convergence_demo {rate:.1f} windows/s; kill/resume "
                   f"max_abs_diff {cmp_['max_abs_diff']:.3e}; phase 19 "
                   f"{wall:.1f} s")


def data_parallel_slice(dev, all_kernels):
    """Phase 20: ``train_pose_model`` for one epoch inside a process group
    of one rank (NCCL) against the same epoch without it, stock ops and
    fused: history, weights and predictions bit for bit, and the same
    launches of every kernel; then ``cli.run`` asking for one rank more
    than the cards must exit nonzero, saying so."""
    import contextlib as cl
    from wiflow_tpu_torch.core.config import (
        Config, MeshConfig, ModelConfig, TrainConfig,
    )
    from wiflow_tpu_torch.parallel import mesh
    from wiflow_tpu_torch.train.loop import train_pose_model
    log("phase 20: data parallel at world size 1 (NCCL) against no process "
        "group")
    t0 = time.perf_counter()
    for name, cfg in (("stock ops", ModelConfig()),
                      ("fused", ModelConfig(**FUSED))):
        xs, ys = train_data(dev, cfg)
        n_tr, n_va = TRAIN_WINDOWS * 3 // 4, TRAIN_WINDOWS // 8
        splits = ((xs[:n_tr], ys[:n_tr]),
                  (xs[n_tr:n_tr + n_va], ys[n_tr:n_tr + n_va]),
                  (xs[n_tr + n_va:], ys[n_tr + n_va:]))
        conf = Config(model=cfg, train=TrainConfig(
            batch_size=TRAIN_BATCH, num_epochs=1, seed=SEED,
            data_dtype="bfloat16"), mesh=MeshConfig(num_devices=1))
        steps = n_tr // TRAIN_BATCH
        want = {n: 2 * steps for n in TRAIN_KERNELS}
        if cfg.tcn_train_impl == "fused":
            want.update({n: STAGE_LAUNCHES[n] * steps for n in STAGE_ATTRS})
        runs = []
        for grouped in (False, True):
            ctx = mesh.process_group(1, dev) if grouped else cl.nullcontext()
            reset_launches(all_kernels)
            with ctx:
                if grouped and mesh.world_size() != 1:
                    raise AssertionError("the process group is not 1 rank")
                r = train_pose_model(*splits, conf, device=dev, verbose=False)
            got = read_launches(all_kernels)
            expect_launches(f"one epoch, {name}, "
                            f"{'in' if grouped else 'without'} a process "
                            f"group", got, want)
            runs.append(r)
        a, b = runs
        same = (a.history == b.history and a.test_metrics == b.test_metrics
                and all(torch.equal(v, b.state_dict[k])
                        for k, v in a.state_dict.items())
                and (a.predictions == b.predictions).all())
        if not same:
            raise AssertionError(f"{name}: the epoch in a process group of "
                                 f"one rank differs from the epoch without")
        log(f"  {name}: one epoch ({steps} steps) in a process group of one "
            f"rank equals the epoch without one bit for bit (history, test "
            f"metrics, weights, predictions); launches "
            f"{json.dumps({n: v for n, v in got.items() if v})}")
    root = os.path.dirname(os.path.abspath(__file__))
    ranks = torch.cuda.device_count() + 1
    proc = subprocess.run([sys.executable, "-m", "wiflow_tpu_torch.cli.run",
                           "--gpu", str(ranks), "--epochs", "1"], cwd=root,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode == 0 or "more ranks than devices" not in proc.stderr:
        raise AssertionError(f"cli.run --gpu {ranks}: rc {proc.returncode}"
                             f"\n{proc.stderr[-2000:]}")
    log(f"  cli.run --gpu {ranks} on {ranks - 1} card(s): exit "
        f"{proc.returncode}, " + proc.stderr.strip().splitlines()[-1])
    wall = time.perf_counter() - t0
    log(f"  phase 20: {wall:.1f} s")
    SUMMARY.append(f"data parallel at 1 rank bit-equal; phase 20 {wall:.1f} s")


def channel_attention_work(n, c, heads, batch, esize):
    """(FLOPs, bytes) of a channel attention launch: the scores and the
    context (2 N C^2 each a head and window); Q, K, V in and the heads'
    mean context out."""
    flops = 4 * batch * heads * n * c * c
    nbytes = batch * n * (3 * heads * c + c) * esize
    return flops, nbytes


def rel_gaps(got, ref):
    """max and RMS of ``got - ref`` over max|ref|."""
    d = got.float() - ref.float()
    scale = ref.float().abs().max().item()
    return d.abs().max().item() / scale, d.pow(2).mean().sqrt().item() / scale


def hold_channel_attention(name, got, ref):
    """``got`` within ``CA_TOL_MAX`` (max) and ``CA_TOL_RMS`` (RMS) of
    ``ref``, as shares of max|ref|; returns max|got - ref|."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {tuple(got.shape)} against "
                             f"{tuple(ref.shape)}, or non-finite values")
    mx, rms = rel_gaps(got, ref)
    ok = mx <= CA_TOL_MAX and rms <= CA_TOL_RMS
    log(f"  {name}: max {mx:.3e}, RMS {rms:.3e} of max|ref| (limits "
        f"{CA_TOL_MAX:.3e}, {CA_TOL_RMS:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max {mx}, RMS {rms}")
    return (got.float() - ref.float()).abs().max().item()


def channel_attention_fault(qkv, heads, kind):
    """``channel_attention_plain`` with a fault planted: ``"norm"`` skips
    the InstanceNorm, ``"head"`` leaves the last head out of the sum."""
    from wiflow_tpu_torch.ops.kernels import channel_attention as ca
    q, k, v = ca.split_heads(qkv, heads)
    s = torch.einsum("bhnc,bhnd->bhcd", q.float(), k.float())
    s = s / math.sqrt(q.shape[-1])
    if kind != "norm":
        mean = s.mean(dim=(-2, -1), keepdim=True)
        var = s.var(dim=(-2, -1), keepdim=True, unbiased=False)
        s = (s - mean) * torch.rsqrt(var + ca.EPS)
    p = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    if kind == "head":
        p[:, -1] = 0
    ctx = torch.einsum("bhcd,bhnd->bnc", p, v.float()) / heads
    return ctx.to(qkv.dtype)


@torch.no_grad()
def wpformer_slice(dev, all_kernels):
    """Phase 21: WPformer's served path and its channel attention kernel
    at published widths (see the module's docstring).  Returns the
    kernel's record row."""
    from wiflow_tpu_torch.eval.streaming import (
        make_stream_infer, sliding_windows,
    )
    from wiflow_tpu_torch.models.baselines import wpformer as wp
    from wiflow_tpu_torch.ops.kernels import channel_attention as ca
    from wiflow_tpu_torch.utils import trace
    b = WPFORMER_BATCH
    log(f"phase 21: WPformer served, batch {b} (bf16), its channel "
        f"attention kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    for bb, n, c, h in CA_SHAPES:
        qkv = (torch.randn((bb, n, 3 * h * c), generator=gen, device=dev)
               .to(torch.bfloat16))
        got = ca.channel_attention(qkv, h)
        same_bits(f"channel attention, random b{bb} n{n} c{c} h{h}", (got,),
                  (ca.channel_attention(qkv, h),))
        hold_channel_attention(f"kernel vs plain, random b{bb} n{n} c{c} "
                               f"h{h}", got, ca.channel_attention_plain(qkv, h))

    model = wp.WPformer(device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    nontrivial_stats(model)
    packed = wp.pack_wpformer(model)
    heads, window = packed.heads, 20
    x = torch.randn((b, 540, window), generator=gen, device=dev)
    seen = {}
    core = wp._served_core

    def keep(qkv, h, which):
        seen["qkv"] = qkv
        return core(qkv, h, which)

    wp._served_core = keep
    try:
        reset_launches(all_kernels)
        out = wp.wpformer_forward(packed, x)
        expect_launches("wpformer_forward", read_launches(all_kernels),
                        {"channel_attention": 1})
    finally:
        wp._served_core = core
    qkv = seen.pop("qkv")
    log(f"  the served projection: qkv {tuple(qkv.shape)} {qkv.dtype}")
    got = ca.channel_attention(qkv, heads)
    same_bits("channel attention, published shape", (got,),
              (ca.channel_attention(qkv, heads),))
    plain = ca.channel_attention_plain(qkv, heads)
    err = hold_channel_attention("kernel vs plain, published shape", got,
                                 plain)
    compare("kernel vs the model's stock-op core", got,
            wp.channel_attention_core(*ca.split_heads(qkv, heads)), TOL_BF16)
    sub, ref = qkv[:CA_FAULT_BATCH], plain[:CA_FAULT_BATCH]
    for kind in ("norm", "head"):
        mx, rms = rel_gaps(channel_attention_fault(sub, heads, kind), ref)
        log(f"  fault {kind!r} planted in the plain version: max {mx:.3e}, "
            f"RMS {rms:.3e} of max|ref|")
        if mx <= CA_TOL_MAX or rms <= CA_TOL_RMS:
            raise AssertionError(f"fault {kind!r} reads within a limit: "
                                 f"max {mx}, RMS {rms}")
    del got, plain, sub, ref
    stock = wp.wpformer_forward(packed, x, core="stock")
    compare("wpformer_forward, kernel vs stock-op core", out, stock, TOL_BF16)

    sgen = torch.Generator(device=dev).manual_seed(SEED + 22)
    stream = torch.randn((b + max(1, b // 5) + window - 1, 540),
                         generator=sgen, device=dev)
    fwd = lambda w: wp.wpformer_forward(packed, w)   # noqa: E731
    infer = make_stream_infer(fwd, window=window, batch=b, device=dev)
    reset_launches(all_kernels)
    trace.collect()
    trace.enable()
    try:
        poses = infer(stream)
    finally:
        trace.disable()
    counts = trace.collect().counts
    expect_launches("the stream over wpformer_forward",
                    read_launches(all_kernels), {"channel_attention": 2})
    log(f"  stream counters: {json.dumps(counts)}")
    if (counts.get("serve.channel_attention_windows") != 2 * b
            or counts.get("stream.rows") != 2 * b):
        raise AssertionError(f"the stream counted {counts}, not {2 * b} "
                             f"rows through the kernel")
    direct = sliding_windows(stream, window)
    compare("stream vs wpformer_forward, first batch", poses[:b],
            fwd(direct[:b]), TOL_F32)
    compare("stream vs wpformer_forward, padded batch", poses[b:],
            fwd(direct[b:]), TOL_BF16)
    del stream, poses, direct

    t = {"kernel": time_ms(lambda: ca.channel_attention(qkv, heads), RUNS),
         "plain": time_ms(lambda: ca.channel_attention_plain(qkv, heads),
                          RUNS),
         "stock": time_ms(lambda: wp.channel_attention_core(
             *ca.split_heads(qkv, heads)), RUNS),
         "forward": time_ms(lambda: fwd(x), RUNS // 2),
         "forward_stock": time_ms(
             lambda: wp.wpformer_forward(packed, x, core="stock"), RUNS // 2)}
    n, c = qkv.shape[1], qkv.shape[2] // (3 * heads)
    bms, by = bound_ms(*channel_attention_work(n, c, heads, b, 2),
                       torch.bfloat16)
    log(f"  channel attention kernel {t['kernel']:.4f} ms (bound {bms:.4f} "
        f"ms by {by}, {100 * bms / t['kernel']:.2f}%), plain "
        f"{t['plain']:.4f}, the model's stock-op core {t['stock']:.4f}")
    log(f"  wpformer_forward {t['forward']:.4f} ms = "
        f"{b / t['forward'] * 1e3:.1f} windows/s (the core "
        f"{100 * t['kernel'] / t['forward']:.2f}%); on the stock-op core "
        f"{t['forward_stock']:.4f} ms (the core "
        f"{100 * t['stock'] / t['forward_stock']:.2f}%); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    SUMMARY.append(f"wpformer_forward b{b} {t['forward']:.4f} ms; channel "
                   f"attention {t['kernel']:.4f} ms ({by}-bound "
                   f"{bms:.4f})")
    return {"name": "channel_attention", "route": "cuda",
            "source": ca.KERNEL.source, "replaces": ca.KERNEL.replaces,
            "launches": 1, "max_abs_err": err, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": bms, "bound_by": by,
            "library_ms": None, "stock_ms": t["stock"],
            "forward_ms": t["forward"], "forward_stock_ms": t["forward_stock"]}


# Phase 22: the conv stack kernel's shapes beyond the served batch (rows =
# windows x frames): the flagship at batch 1, 7, 4095 and 4096; MM-Fi's
# chunks (multiples of 297 windows and 4096, of 10 frames); odd widths.
CONV_SWEEP = (("flagship", 240, (20, 140, 81900, 81920)),
              ("mmfi", 272, (2970, 11880, 20790, 38610, 40960)),
              ("odd", 241, (7, 301)), ("odd", 33, (1, 300)),
              ("odd", 17, (64,)))


def parent_conv_stack(root, name="parent"):
    """The conv stack module of another checkout (the parent commit) and
    its kernel, built by nvcc from that checkout's ``csrc`` with this
    tree's flags into that checkout's build directory."""
    import ctypes
    import importlib.util
    from pathlib import Path
    from wiflow_tpu_torch.ops.kernels import build as kbuild
    root = Path(root).resolve()
    out = root / "wiflow_tpu_torch" / "build" / f"libconv_stack-{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(out),
                    str(root / "wiflow_tpu_torch" / "csrc" / "conv_stack.cu")],
                   check=True, capture_output=True, text=True)
    log(f"  the {name}'s conv_stack built from {root}: "
        f"{time.perf_counter() - t0:.1f} s")
    spec = importlib.util.spec_from_file_location(
        f"{name}_conv_stack",
        root / "wiflow_tpu_torch" / "ops" / "kernels" / "conv_stack.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, mod.KERNEL.symbol)
    fn.argtypes, fn.restype = mod.KERNEL.argtypes, ctypes.c_int
    lib.wf_error_string.argtypes = [ctypes.c_int]
    lib.wf_error_string.restype = ctypes.c_char_p
    mod.KERNEL._lib, mod.KERNEL._fn = lib, fn
    return mod


@torch.no_grad()
def conv_stack_slice(dev, parent=None):
    """Phase 22: the conv stack kernel (bf16 on wgmma, fp32 on CUDA cores)
    on random weights (``random_serving_weights``) and N(0, 1) rows at
    the shapes of ``CONV_SWEEP``: both dtypes against the fp32 plain
    version, a relaunch bit-equal, the plan and the wgmma count printed.
    With ``parent`` (a checkout of the parent commit), the parent's
    kernel too: fp32 bit-equal to it, and rows 2 (batch 4096) and the
    MM-Fi line timed beside it in turns, parent, this, this, parent.
    Returns {model: (ms, parent ms or None)}."""
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.models.wiflow_mmfi import MMFiModelConfig
    from wiflow_tpu_torch.ops.kernels import conv_stack as conv_k
    bf = torch.bfloat16
    log("phase 22: the conv stack kernel, shapes and the parent")
    old = parent_conv_stack(parent) if parent else None
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    cfgs = {"flagship": ModelConfig(), "mmfi": MMFiModelConfig(),
            "odd": ModelConfig()}
    times = {}
    for name, w0, row_counts in CONV_SWEEP:
        _, blocks = random_serving_weights(cfgs[name], gen, dev)
        packed = {dt: conv_k.stack_weights([conv_k.ConvBlockWeights(
            *[v.to(dt) if isinstance(v, torch.Tensor) and v.ndim > 1 else v
              for v in blk]) for blk in blocks]) for dt in (torch.float32, bf)}
        chans = conv_k._chans(packed[bf])
        x = torch.randn((max(row_counts), w0), generator=gen, device=dev)
        for rows in row_counts:
            xr = x[:rows]
            plan = conv_k.conv_stack_plan(rows, w0, chans, bf)
            tag = f"conv stack {name} w0 {w0}, {rows} rows"
            log(f"  {tag}: plan {plan.wgs} warpgroups x {plan.tile_rows} "
                f"rows, grid {plan.grid}, {plan.smem} bytes, "
                f"{plan.wgmma_convs} convs on wgmma")
            ref = conv_k.conv_stack_plain(xr, packed[torch.float32])
            before = conv_k.wgmma_convs
            got = conv_k.fused_conv_stack_eval(xr.to(bf), packed[bf])
            if conv_k.wgmma_convs - before != plan.wgmma_convs:
                raise AssertionError(f"{tag}: {conv_k.wgmma_convs - before} "
                                     f"convs counted on wgmma, the plan "
                                     f"says {plan.wgmma_convs}")
            compare(f"{tag} bf16", got, ref, TOL_BF16)
            same_bits(f"{tag} bf16", [got], [conv_k.fused_conv_stack_eval(
                xr.to(bf), packed[bf])])
            got32 = conv_k.fused_conv_stack_eval(xr, packed[torch.float32])
            compare(f"{tag} fp32", got32, ref, TOL_F32)
            if old is not None:
                old32 = old.stack_weights(packed[torch.float32].blocks)
                if not torch.equal(got32, old.fused_conv_stack_eval(xr,
                                                                    old32)):
                    raise AssertionError(f"{tag} fp32: differs from the "
                                         f"parent's kernel")
                log(f"  {tag} fp32: equal to the parent's bit for bit")
            del ref, got, got32
        if name == "odd":
            continue
        rows = max(row_counts)
        x16 = x[:rows].to(bf)
        kfn = lambda: conv_k.fused_conv_stack_eval(x16, packed[bf])  # noqa
        if old is None:
            ms, pms = time_ms(kfn, RUNS), None
        else:
            old16 = old.stack_weights(packed[bf].blocks)
            pfn = lambda: old.fused_conv_stack_eval(x16, old16)  # noqa
            p1, m1, m2, p2 = (time_ms(f, RUNS) for f in (pfn, kfn, kfn, pfn))
            ms, pms = statistics.median([m1, m2]), statistics.median([p1, p2])
            log(f"  conv stack {name}, {rows} rows, bf16, turns parent / "
                f"this / this / parent: {p1:.4f} / {m1:.4f} / {m2:.4f} / "
                f"{p2:.4f} ms")
        bms, by = bound_ms(*conv_work(cfgs[name], rows, 2), bf)
        log(f"  conv stack {name}, {rows} rows, bf16: {ms:.4f} ms"
            + ("" if pms is None else f" (parent {pms:.4f} ms)")
            + f", bound {bms:.4f} ms ({by}), {100 * bms / ms:.2f}% of it")
        SUMMARY.append(f"conv stack {name} {rows} rows {ms:.4f} ms"
                       + ("" if pms is None else f" (parent {pms:.4f})"))
        times[name] = (ms, pms)
    torch.cuda.synchronize()
    return times


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="the port on one CUDA card")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: phase 22 times "
                         "the conv stack kernel beside its")
    args = ap.parse_args(argv)
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
    train16, train_errs = check_train_kernels(dev, c, g)
    state, xs, ys, train_launches = train_slice(dev, all_kernels)
    xb, yb = xs[:TRAIN_BATCH], ys[:TRAIN_BATCH]
    record += train_timings(state, xb, yb, train16["main"], c, g,
                            train_launches, train_errs["main"])

    # -- phases 8-10: the stage-fused training path --------------------------
    stage_errs = check_stage_kernels(dev, cfg16)
    fused_state, fused_launches = fused_slice(dev, all_kernels, xs, ys)
    record += fused_timings(dev, cfg16, state, fused_state, xb, yb,
                            fused_launches, stage_errs)
    del state, fused_state, xs, ys, xb, yb
    torch.cuda.empty_cache()

    # -- phase 14: the CLI, resume, and the trained weights served ----------
    trained = cli_slice(dev, all_kernels)

    # -- phase 15: MM-Fi training on the card ---------------------------------
    mmfi_training(dev, all_kernels, train16["mmfi"], train_errs["mmfi"],
                  record)

    # -- phase 16: the ablations ---------------------------------------------
    ablation_slice(dev, all_kernels, record)

    # -- phase 17: the baselines ---------------------------------------------
    baseline_slice(dev, all_kernels)

    # -- phase 18: the robustness kit -----------------------------------------
    robustness_slice(dev, all_kernels, trained)
    del trained

    # -- phase 19: the demo CLIs ---------------------------------------------
    demo_slice(dev, all_kernels)

    # -- phase 20: data parallelism at one rank ------------------------------
    data_parallel_slice(dev, all_kernels)

    # -- phase 21: WPformer served, its channel attention kernel ------------
    record.append(wpformer_slice(dev, all_kernels))

    # -- phase 22: the conv stack kernel's shapes, beside the parent's ------
    conv_stack_slice(dev, args.parent)

    log(smi)
    log(json.dumps({"kernels": record}))
    log("summary: " + "; ".join(SUMMARY))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
