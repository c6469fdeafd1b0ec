"""What bounds the eval attention kernels on the card: ablations.

    python3 attention_ablations.py        # from the repo root, one CUDA card

The port's attention kernels (``csrc/axial_attention.cu``, v2, and
``csrc/axial_attention_dual.cu``, both axes in one launch, which share the
projection and the core of ``csrc/axial_attention_eval.cuh``; and
``csrc/axial_attention_v1.cu``, the core alone on a precomputed
projection) are built again from copies of ``csrc/`` in which one stage is
cut out, into ``wiflow_tpu_torch/build/ablations/<n>/``:

* without the projection (``project_tile`` returns at once);
* without the core, and so without its stores (``attend_tile`` returns at
  once);
* without the core's stores (a store no finite input takes, so the core's
  arithmetic stays);
* without the one-launch kernel's fetches of weights after its first.

The package's sources are not touched.  At both models' attention shapes
(``[4096, 15, 20, 64]`` and ``[4096, 17, 10, 64]``, 8 groups) in bf16, on
N(0, 1) inputs through random folded weights (``chip_smoke.random_axes``),
each kernel and each of its cut builds is timed with CUDA events (median
of 20 after warm-up) in 3 alternating rounds, and the median of the rounds
printed.  The whole kernels are also held to their plain versions; a cut
kernel's output is meaningless and is not checked.  The last line is the
card's name and power limit.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import shutil
import statistics
import subprocess
import sys

import torch

from chip_smoke import random_axes
from wiflow_tpu_torch.ops.kernels import axial_attention as ak
from wiflow_tpu_torch.ops.kernels import build as kbuild

BATCH = 4096
RUNS = 20
ROUNDS = 3
SHAPES = {"flagship": (15, 20), "MM-Fi": (17, 10)}
C, G = 64, 8
LIBRARIES = {"v2": "KERNEL", "dual": "KERNEL_DUAL", "v1": "KERNEL_V1"}
HEADER = "axial_attention_eval.cuh"
# cut -> [(file of csrc/, text, replacement)]
CUTS = {
    "without the projection": [(
        HEADER, "float* qkv) {\n  if (c / kGroupChannels % 4 == 0)",
        "float* qkv) {\n  return;\n  if (c / kGroupChannels % 4 == 0)")],
    "without the core": [(HEADER, "  constexpr int Q = kQueries;\n",
                          "  return;\n  constexpr int Q = kQueries;\n")],
    "without the core's stores": [(
        HEADER, "      if (u < nq) store_group(dst(s, i0 + u, g), out);",
        "      if (!(den[u] == den[u]))"
        " store_group(dst(s, i0 + u, g), out);")],
    "without the dual kernel's weight fetches after the first": [
        ("axial_attention_dual.cu",
         "      else\n        stage_weights<T>(a.height, c, ws);",
         "      else if (false)\n        stage_weights<T>(a.height, c, ws);"),
        ("axial_attention_dual.cu",
         "        stage_weights<T>(a.width, c, ws);\n"
         "        stage_rows(a, x + gridDim.x * sample, a1, 0);",
         "        stage_rows(a, x + gridDim.x * sample, a1, 0);")],
}


def cut_builds():
    """{cut: {lowering: CudaKernel}} for the libraries each cut changes,
    built in parallel from edited copies of ``csrc/``."""
    root = kbuild.BUILD_DIR / "ablations"
    nvcc = kbuild._nvcc()
    procs, out = [], {}
    for i, (cut, edits) in enumerate(CUTS.items()):
        src = root / str(i) / "csrc"
        shutil.rmtree(src.parent, ignore_errors=True)
        shutil.copytree(kbuild.CSRC_DIR, src)
        changed = set()
        for name, old, new in edits:
            text = (src / name).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{cut}: the text to cut is not once in "
                                   f"{name}")
            (src / name).write_text(text.replace(old, new))
            changed.add(name)
        out[cut] = {}
        for low, attr in LIBRARIES.items():
            kernel = getattr(ak, attr)
            if HEADER not in changed and f"{kernel.name}.cu" not in changed:
                continue
            lib = src.parent / f"lib{kernel.name}.so"
            procs.append((cut, subprocess.Popen(
                [nvcc, *kbuild.NVCC_FLAGS, "-o", str(lib),
                 str(src / f"{kernel.name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
            out[cut][low] = (kernel, lib)
    for cut, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc, {cut}:\n{log}")
    return {cut: {low: loaded(k, lib) for low, (k, lib) in libs.items()}
            for cut, libs in out.items()}


def loaded(kernel, lib):
    """``kernel``'s entry point from the library ``lib``, with a launch
    count of its own."""
    k = copy.copy(kernel)
    k._lib = ctypes.CDLL(str(lib))
    k._fn = getattr(k._lib, k.symbol)
    k._fn.argtypes, k._fn.restype = k.argtypes, ctypes.c_int
    k._lib.wf_error_string.argtypes = [ctypes.c_int]
    k._lib.wf_error_string.restype = ctypes.c_char_p
    k.launches = 0
    return k


@contextlib.contextmanager
def swapped(low, kernel):
    """The module's kernel of lowering ``low`` replaced by ``kernel``."""
    attr = LIBRARIES[low]
    keep = getattr(ak, attr)
    setattr(ak, attr, kernel or keep)
    try:
        yield
    finally:
        setattr(ak, attr, keep)


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def err(got, ref) -> float:
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("attention_ablations: no CUDA device")
    dev = torch.device("cuda")
    kbuild.build([k.name for k in (ak.KERNEL, ak.KERNEL_DUAL, ak.KERNEL_V1)])
    cuts = cut_builds()
    gen = torch.Generator(device=dev).manual_seed(7)
    for shape, (h, w) in SHAPES.items():
        axes = tuple(ak.axis_weights(aw._replace(wq=aw.wq.to(torch.bfloat16)))
                     for aw in random_axes(C, G, gen, dev))
        x = torch.randn((BATCH, h, w, C), generator=gen,
                        device=dev).to(torch.bfloat16)
        qkvs = [ak.project_qkv_v1(x, axes[0])]
        mid = ak.axial_attention_v1_plain(qkvs[0], axes[0].sim,
                                          axes[0].oaff, True)
        qkvs.append(ak.project_qkv_v1(mid, axes[1]))
        runs = {
            "v2": lambda: ak.dual_axial_attention_eval(x, axes),
            "dual": lambda: ak.dual_axial_attention_eval_fused(x, axes),
            "v1": lambda: [ak.axial_attention_v1(q, aw.sim, aw.oaff, wd)
                           for q, aw, wd in zip(qkvs, axes, (True, False))],
        }
        plain = ak.dual_axial_attention_fused_plain(x, axes).float()
        v1_plain = [ak.axial_attention_v1_plain(q.float(), aw.sim, aw.oaff,
                                                wd).float()
                    for q, aw, wd in zip(qkvs, axes, (True, False))]
        errs = {"v2": err(runs["v2"](), plain),
                "dual": err(runs["dual"](), plain),
                "v1": max(err(y, p) for y, p in zip(runs["v1"](), v1_plain))}
        cases = [(low, "whole", None) for low in LIBRARIES] + [
            (low, cut, k) for cut, libs in cuts.items()
            for low, k in libs.items()]
        times = {(low, cut): [] for low, cut, _ in cases}
        for _ in range(ROUNDS):
            for low, cut, k in cases:
                with swapped(low, k):
                    times[low, cut].append(time_ms(runs[low]))
        for low, cut, k in cases:
            if k is not None and k.launches == 0:
                raise AssertionError(f"{low} {cut}: the cut build never ran")
            line = (f"{shape} {low} {cut}: "
                    f"{statistics.median(times[low, cut]):.4f} ms (rounds "
                    + ", ".join(f"{t:.4f}" for t in times[low, cut]) + ")")
            if k is None:
                line += f"; max error / max|plain| {errs[low]:.3e}"
            print(line, flush=True)
        del x, qkvs, mid, plain, v1_plain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
