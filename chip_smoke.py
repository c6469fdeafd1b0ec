#!/usr/bin/env python3
"""Drive the port's serving and training paths on one NVIDIA GPU and check
their kernels.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits nonzero; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of the seven CUDA libraries from ``wiflow_tpu_torch/csrc``
   (one nvcc each, started together), with ptxas's registers and spills
   under each kernel's name;
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes for batch 4096 (TCN ``[4096, 20, 540]``, conv stack
   ``[81920, 240]``, attention ``[4096, 15, 20, 64]``): fp32 with TF32 off,
   and bf16 against the fp32 plain version;
3. the slice end to end: the default ``ModelConfig`` (bf16) with seeded
   weights, ``fast_forward`` at batch 4096 (and at batch 7, which leaves
   thread blocks part-filled) against the port's plain-torch module, and
   ``make_stream_infer`` over a ``[4096 + 19, 540]`` stream; every launch
   counter is reset before and read after the batch-4096 run and the
   stream;
4. timings from CUDA events (warm-up, then the median of several runs):
   each kernel, its plain version, the decoder and ``fast_forward``;
5. the four train kernels (``axial_core`` and ``logits_sums``, forward and
   backward) against their plain versions at the train step's shapes for
   batch 256 (width axis n=3840, L=20; height axis n=5120, L=15) and at 7
   sequences, which leave the last thread block part-filled: fp32 with
   TF32 off, the ``[2, G]`` sums and ``dscale`` also against float64, and
   bf16 against the fp32 plain version;
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
   the step's device time; each train kernel against its plain version,
   its bound and ``scaled_dot_product_attention``; peak memory;
8. the ``stage`` and ``join`` kernels, forward and backward, against their
   plain versions at the fused train step's shapes for batch 256 (every
   conv geometry, with prologue, mask and bias as the model uses them) and
   at 7 samples, which leave the last thread block part-filled: fp32 with
   TF32 off, the sums and the prologue's gradients also against float64,
   and bf16 against the fp32 plain version; a second launch of each must
   repeat the first bit for bit;
9. the fused training slice: the default ``ModelConfig`` with
   ``tcn_train_impl = conv_train_impl = "fused"``, trained as in phase 6
   (one step must launch ``stage`` 39 times and ``join`` 9 times, forward
   and backward, and each attention kernel twice); one fp32 step with
   dropout on, from one seed, through the fused path against the same step
   through the stock-op path, held to twice the step's fp32 rounding noise
   (measured as stock ops on the card against stock ops on the CPU); one
   ``train_pose_model`` epoch;
10. timings: ``stage`` and ``join`` over the launches of one step and per
   geometry, against their plain versions, their bounds and, where a stage
   is a bare convolution, ``F.conv1d`` / ``F.conv2d``; the fused step
   against the stock-op step in alternating turns, and the profiler's
   breakdown of the fused step.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
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
    """(FLOPs, bytes) of the four TCN level launches."""
    t, g = cfg.window_size, cfg.tcn_groups
    flops = nbytes = 0
    cin = cfg.num_subcarriers
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
    """(FLOPs, bytes) of the conv-stack launch."""
    w, ci = cfg.tcn_channels[-1], 1
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
    """(label, sequences, length) of the train kernels' launches: both
    axes of the ``[256, 15, 20, 64]`` attention input, then 7 sequences,
    which leave the last thread block part-filled."""
    h, w = 15, 20
    return [("width", TRAIN_BATCH * h, w), ("height", TRAIN_BATCH * w, h),
            ("width, 7 seqs", 7, w), ("height, 7 seqs", 7, h)]


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


def check_train_kernels(dev, c, g):
    """Phase 5.  Returns the bf16 inputs of the two main axes (for the
    timings of phase 7) and each kernel's largest bf16 error on them."""
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
    log(f"phase 5: train kernels vs plain versions, batch {TRAIN_BATCH} "
        f"shapes")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    errs = dict.fromkeys(TRAIN_KERNELS, 0.0)
    main16 = []
    for label, n, length in train_axes():
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
            e = {"axial_core_fwd": compare(
                f"axial_core fwd {tag}",
                tk.axial_core_forward(qt, kt, vt, scale), core32[0], tol)}
            grads = tk.axial_core_backward(qt, kt, vt, scale, dout.to(dt))
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
            if dt == torch.bfloat16 and "seqs" not in label:
                errs = {x: max(errs[x], e[x]) for x in errs}
        if "seqs" not in label:
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
                for k in all_kernels.values():
                    k.launches = 0
                m = train_step(state, xs[bi], ys[bi])
                torch.cuda.synchronize()
                launches = {n: k.launches for n, k in all_kernels.items()}
                log(f"kernels launched by one train step: "
                    f"{json.dumps(launches)}")
                want = {n: expect.get(n, 0) for n in all_kernels}
                if launches != want:
                    raise AssertionError(f"one train step launched "
                                         f"{launches}, expected {want}")
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
        "stage_forward_kernel", "stage_dgrad_kernel", "stage_wgrad_kernel",
        "join_forward_kernel", "join_backward_kernel", "reduce_rows",
        "reduce_affine_grads")),
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


def profile_step(step, step_ms: float, runs: int = 5, top: int = 20) -> None:
    """Log the device time of ``step()`` (``torch.profiler``, per step):
    the device's busy and idle shares of the step, the time by class of
    kernel and the largest kernels.  Only device-side kernels and copies
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
    log("  largest kernels by self device time:")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"    {ms:8.4f} ms {ms / busy:6.1%} x{count:g} {key[:90]}")


def train_timings(state, xb, yb, main16, c, g, launches, errs):
    """Phase 7: the train step, then each train kernel alone (both axes,
    as one train step launches it) against its plain version, its bound
    and, for ``axial_core``, ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
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
    profile_step(kernel_step, step_ms)

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
    record = []
    for name, (kfn, pfn, lfn) in cases.items():
        ms = time_ms(kfn, RUNS)
        plain_ms = time_ms(pfn, max(3, RUNS // 4))
        lib_ms = time_ms(lfn, RUNS) if lfn else None
        flops, nbytes = train_work(name, shapes, c, g, 2)
        bms, by = bound_ms(flops, nbytes, torch.bfloat16)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"  {name} (both axes): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention {lib}, bound "
            f"{bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e9:.4f} GB)")
        kern = getattr(tk, KERNEL_ATTRS[name])
        record.append({"name": name, "route": "cuda", "source": kern.source,
                       "replaces": kern.replaces, "launches": launches[name],
                       "max_abs_err": errs[name], "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "library_ms": lib_ms})
    share = sum(r["ms"] for r in record)
    log(f"  the four train kernels alone: {share:.4f} ms = "
        f"{share / step_ms:.1%} of the train step")
    return record


def step_launches(cfg, batch):
    """The ``stage`` and ``join`` launches of one fused train step of
    ``cfg`` at ``batch``, in the model's order, as dicts: a stage's
    geometry, the leading shape and channels of its input, and whether it
    has a prologue, a mask (one bit per element or per (sample, channel)),
    a bias, and an input that needs a gradient."""
    t, g = cfg.window_size, cfg.tcn_groups
    stages, joins = [], []

    def stage(kind, lead, ci, co, groups=1, dil=1, pro=False, mask=None,
              bias=False, need_gx=True):
        stages.append(dict(kind=kind, lead=lead, ci=ci, co=co, groups=groups,
                           dil=dil, pro=pro, mask=mask, bias=bias,
                           need_gx=need_gx))

    cin = cfg.num_subcarriers
    for i, cout in enumerate(cfg.tcn_channels):
        lead, first = (batch, t), i == 0
        if cin != cout:
            stage("identity", lead, cin, cout, need_gx=not first)
        stage("causal3", lead, cin, cin, g, 2 ** i, need_gx=not first)
        stage("identity", lead, cin, cout, pro=True)
        stage("causal3", lead, cout, cout, g, 2 ** i, pro=True, mask="element")
        stage("identity", lead, cout, cout, pro=True)
        joins.append(dict(lead=lead, c=cout, mask="element",
                          res_norm=cin != cout, act_h=True))
        cin = cout
    w, ci = cfg.tcn_channels[-1], 1
    for k, co in enumerate((cfg.conv_channels[0],) + tuple(cfg.conv_channels)):
        strided = k > 0
        wout = (w - 1) // 2 + 1 if strided else w
        stage("chunk1" if strided else "identity", (batch, t, w), ci, co,
              need_gx=strided)
        stage("chunk3" if strided else "sym3", (batch, t, w), ci, co,
              bias=True, need_gx=strided)
        for _ in range(2):
            stage("sym3", (batch, t, wout), co, co, pro=True, mask="sample",
                  bias=True)
        joins.append(dict(lead=(batch, t, wout), c=co, mask=None,
                          res_norm=True, act_h=False))
        ci, w = co, wout
    return stages, joins


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
        f"{TRAIN_BATCH} shapes and 7 samples")
    keep = 1.0 - cfg.dropout
    stages, joins = step_launches(cfg, TRAIN_BATCH)
    small_s, small_j = step_launches(cfg, 7)

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
    ]
    join_cases = [
        pick(joins, c=540), pick(joins, c=440),
        pick(joins, c=8, lead=(TRAIN_BATCH, 20, 240)), pick(joins, c=64),
        pick(small_j, c=240), pick(small_j, c=16),
        # the combinations the default model does not use
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
        leaves = (i["h"], *i["vh"], i["res"], *i["vr"])
        (o32,), g32 = plain_grads(fn, leaves, (i["go"],), torch.float32)
        _, g64 = plain_grads(fn, leaves, (i["go"],), torch.float64)
        main = c["lead"][0] == TRAIN_BATCH
        for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            tag = f"{case_label(c)}, {'fp32' if dt == torch.float32 else 'bf16'}"
            h, res, go = (i[k].to(dt) for k in ("h", "res", "go"))
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
            ref = [g32[0], *g64[1:4], g32[4], *g64[5:]]
            e = worst(f"bwd {tag}", [
                (n + (" vs float64" if n[:2] == "g_" else ""), a, r)
                for n, a, r in zip(names, got, ref) if r is not None], tol)
            if main and dt == torch.bfloat16:
                errs["join_bwd"] = max(errs["join_bwd"], e)
    torch.cuda.synchronize()
    log("  every stage and join launch, run twice on the same inputs, gave "
        "the same bits")
    return errs


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
    import torch.nn.functional as F
    from wiflow_tpu_torch.ops.kernels import stage_fused as sk
    from wiflow_tpu_torch.train.steps import train_step
    log(f"phase 10: stage and join timings, bf16, batch {TRAIN_BATCH} (CUDA "
        f"events, median of {RUNS})")
    keep = 1.0 - cfg.dropout
    dt = torch.bfloat16
    stages, joins = step_launches(cfg, TRAIN_BATCH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

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
    log("  per launch: kernel / plain / bound ms, forward then backward; "
        "F.conv where the stage is a bare convolution")
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
        log(f"    {label}: fwd {time_ms(f['fwd'], RUNS):.4f} / "
            f"{time_ms(f['plain_fwd'], plain_runs):.4f} / {bf:.4f} ({byf})"
            f"{lib}; bwd {time_ms(f['bwd'], RUNS):.4f} / "
            f"{time_ms(f['plain_bwd'], plain_runs):.4f} / {bb:.4f} ({byb})")

    # summed over the launches of one train step
    record = []
    for name, fns, work, key in (("stage_fwd", sfn, swork, "fwd"),
                                 ("stage_bwd", sfn, swork, "bwd"),
                                 ("join_fwd", jfn, jwork, "fwd"),
                                 ("join_bwd", jfn, jwork, "bwd")):
        ms = time_ms(lambda: [f[key]() for f in fns], RUNS)
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
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        lib = ""
        if name == "stage_fwd":
            bare = [f for f in fns if f["lib"] is not None]
            row["library_ms"] = time_ms(lambda: [f["lib"]() for f in bare],
                                        RUNS)
            row["library_launches"] = len(bare)
            row["ms_of_library_launches"] = time_ms(
                lambda: [f["fwd"]() for f in bare], RUNS)
            lib = (f"; the {len(bare)} launches that are bare convolutions: "
                   f"kernel {row['ms_of_library_launches']:.4f} ms, F.conv "
                   f"{row['library_ms']:.4f} ms")
        log(f"  {name}, the {len(fns)} launches of one step: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"(mostly {by}; {sum(w[which][0] for w in work) / 1e9:.3f} "
            f"GFLOP, {sum(w[which][1] for w in work) / 1e9:.4f} GB){lib}")
        record.append(row)
    del sfn, jfn
    torch.cuda.empty_cache()

    # the fused step against the stock-op step, in turns as in phase 7
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
    profile_step(fused_step, fused_ms)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.eval.streaming import (
        make_stream_infer, sliding_windows,
    )
    from wiflow_tpu_torch.models.fast import decode, fast_forward, pack_fast
    from wiflow_tpu_torch.models.torch_compat import load_state_dict
    from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
    from wiflow_tpu_torch.ops.kernels import axial_attention as attn_k
    from wiflow_tpu_torch.ops.kernels import axial_attention_train as train_k
    from wiflow_tpu_torch.ops.kernels import build as kbuild
    from wiflow_tpu_torch.ops.kernels import conv_stack as conv_k
    from wiflow_tpu_torch.ops.kernels import stage_fused as stage_k
    from wiflow_tpu_torch.ops.kernels import tcn_level as tcn_k

    # -- phase 1: card, versions, build ------------------------------------
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
                   **{n: getattr(train_k, a) for n, a in KERNEL_ATTRS.items()},
                   **{n: getattr(stage_k, a) for n, a in STAGE_ATTRS.items()}}
    libraries = sorted({k.name for k in all_kernels.values()})
    t0 = time.perf_counter()
    secs = kbuild.build(libraries)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for lib in libraries:
        path = kbuild.BUILD_DIR / f"{lib}.log"
        for fn, line in ptxas_report(path.read_text()):
            log(f"  ptxas {lib} {fn}: {line}")
    for k in all_kernels.values():
        k.load()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    dev = torch.device("cuda")
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
    errs = {}
    with torch.no_grad():
        h = x32.transpose(1, 2).contiguous()        # [B, T, 540]
        tcn_in = h
        e = 0.0
        for i, (l32, l16) in enumerate(zip(packed32.tcn, packed16.tcn)):
            ref = tcn_k.tcn_level_plain(h, l32)
            compare(f"tcn level {i} fp32", tcn_k.tcn_level(h, l32), ref,
                    TOL_F32)
            e = max(e, compare(f"tcn level {i} bf16",
                               tcn_k.tcn_level(h.to(torch.bfloat16), l16),
                               ref, TOL_BF16))
            h = ref
        errs["tcn_level"] = e
        rows = h.reshape(b * t, -1)                  # [B*T, 240]
        ref = conv_k.conv_stack_plain(rows, packed32.conv)
        compare("conv stack fp32", conv_k.fused_conv_stack_eval(
            rows, packed32.conv), ref, TOL_F32)
        errs["conv_stack"] = compare(
            "conv stack bf16", conv_k.fused_conv_stack_eval(
                rows.to(torch.bfloat16), packed16.conv), ref, TOL_BF16)
        # 101 rows leave the last thread block part-filled
        compare("conv stack fp32, 101 rows", conv_k.fused_conv_stack_eval(
            rows[:101], packed32.conv), ref[:101], TOL_F32)
        compare("conv stack bf16, 101 rows", conv_k.fused_conv_stack_eval(
            rows[:101].to(torch.bfloat16), packed16.conv), ref[:101],
            TOL_BF16)
        a_in = ref.reshape(b, t, *ref.shape[1:]).permute(0, 3, 1, 2)
        a_in = a_in.contiguous()                     # [B, 15, 20, 64]
        ref_dev = attn_k.axial_attention_plain(
            attn_k.axial_attention_plain(a_in, packed32.attention[0], True),
            packed32.attention[1], False)
        compare("attention fp32", attn_k.dual_axial_attention_eval(
            a_in, packed32.attention), ref_dev, TOL_F32)
        errs["axial_attention"] = compare(
            "attention bf16", attn_k.dual_axial_attention_eval(
                a_in.to(torch.bfloat16), packed16.attention), ref_dev,
            TOL_BF16)
        del ref_dev
        torch.cuda.synchronize()

        # -- phase 3: the slice end to end ----------------------------------
        log(f"phase 3: fast_forward at batch {b} (bf16) and streaming")
        for k in all_kernels.values():
            k.launches = 0
        out16 = fast_forward(packed16, x32)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        log(f"kernels launched by fast_forward: {json.dumps(launches)}")
        if not all(launches.values()):
            raise AssertionError(f"a kernel did not run: {launches}")
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
        for k in all_kernels.values():
            k.launches = 0
        poses = infer(stream)
        torch.cuda.synchronize()
        stream_launches = {n: k.launches for n, k in kernels.items()}
        log(f"kernels launched by the stream: {json.dumps(stream_launches)}")
        if not all(stream_launches.values()):
            raise AssertionError(f"a kernel did not run: {stream_launches}")
        direct = fast_forward(packed16, sliding_windows(stream, t))
        compare("stream vs fast_forward on the same windows", poses, direct,
                TOL_F32)
        stream_ms = time_ms(lambda: infer(stream), RUNS)
        log(f"stream of {stream.shape[0]} frames ({b} windows, bf16): "
            f"{stream_ms:.4f} ms = {b / stream_ms * 1e3:.1f} windows/s "
            f"(CUDA events, median of {RUNS})")

        # -- phase 4: timings ----------------------------------------------
        log(f"phase 4: timings (CUDA events, median of {RUNS})")
        tin16 = tcn_in.to(torch.bfloat16)
        rows16 = rows.to(torch.bfloat16)
        a16 = a_in.to(torch.bfloat16)
        def tcn_plain_stack():
            y = tin16
            for lv in packed16.tcn:
                y = tcn_k.tcn_level_plain(y, lv)
            return y

        cases = {
            "tcn_level": (lambda: tcn_k.fused_tcn_eval(tin16, packed16.tcn),
                          tcn_plain_stack, tcn_work(cfg16, b, 2)),
            "conv_stack": (lambda: conv_k.fused_conv_stack_eval(
                rows16, packed16.conv),
                lambda: conv_k.conv_stack_plain(rows16, packed16.conv),
                conv_work(cfg16, b * t, 2)),
            "axial_attention": (lambda: attn_k.dual_axial_attention_eval(
                a16, packed16.attention),
                lambda: attn_k.axial_attention_plain(
                    attn_k.axial_attention_plain(
                        a16, packed16.attention[0], True),
                    packed16.attention[1], False),
                attention_work(cfg16, b, 2)),
        }
        record = []
        for name, (kfn, pfn, (flops, nbytes)) in cases.items():
            ms = time_ms(kfn, RUNS)
            plain_ms = time_ms(pfn, max(3, RUNS // 4))
            bms, by = bound_ms(flops, nbytes, torch.bfloat16)
            log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e9:.4f} GB), fp32 CUDA-core bound "
                f"{flops / PEAK_FLOPS[torch.float32] * 1e3:.4f} ms")
            record.append({"name": name, "route": "cuda",
                           "source": kernels[name].source,
                           "replaces": kernels[name].replaces,
                           "launches": launches[name],
                           "max_abs_err": errs[name], "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bms,
                           "bound_by": by, "library_ms": None})
        dec_in = attn_k.dual_axial_attention_eval(a16, packed16.attention)
        dec_ms = time_ms(lambda: decode(packed16, dec_in), RUNS)
        log(f"  decoder (3x3 and 1x1 conv in torch, mean): {dec_ms:.4f} ms")
        ff_ms = time_ms(lambda: fast_forward(packed16, x32), RUNS)
        mod_ms = time_ms(lambda: model16(x32), max(3, RUNS // 4))
        log(f"fast_forward bf16 batch {b}: {ff_ms:.4f} ms = "
            f"{b / ff_ms * 1e3:.1f} windows/s; plain-torch module bf16: "
            f"{mod_ms:.4f} ms = {b / mod_ms * 1e3:.1f} windows/s")
        rest = ff_ms - dec_ms - sum(r["ms"] for r in record)
        log(f"  fast_forward less kernels and decoder (input cast, layout "
            f"copies, launch gaps): {rest:.4f} ms")
        log(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

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

    log(smi)
    log(json.dumps({"kernels": record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
