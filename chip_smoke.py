#!/usr/bin/env python3
"""Drive the port's serving path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits nonzero; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of the three CUDA kernels from ``wiflow_tpu_torch/csrc``
   (one nvcc each, started together);
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
   each kernel, its plain version, the decoder and ``fast_forward``.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
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

# The serving path's batch (``bench.py``'s serving measurement), the
# CUDA-event timings per median, and the seed of weights and inputs.
BATCH = 4096
RUNS = 20
SEED = 0


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
    from wiflow_tpu_torch.ops.kernels import build as kbuild
    from wiflow_tpu_torch.ops.kernels import conv_stack as conv_k
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
    t0 = time.perf_counter()
    secs = kbuild.build(kernels)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in kernels:
        path = kbuild.BUILD_DIR / f"{name}.log"
        for line in path.read_text().splitlines() if path.exists() else []:
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for k in kernels.values():
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
        for k in kernels.values():
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
        for k in kernels.values():
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

    log(smi)
    log(json.dumps({"kernels": record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
