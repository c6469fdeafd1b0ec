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
  once); for v1 that leaves the floor of its ring: the bulk copies of
  each tile's rows and their move into the fp32 layout;
* without the core's stores (a store no finite input takes, so the core's
  arithmetic stays);
* without the one-launch kernel's fetches of weights after its first;
* v1 without its loads (no bulk copies: the move and the core run on
  what the ring holds), without its move into the fp32 layout (the core
  runs on the tile as it lies), and without both, its staging.

And v1 variants, whose outputs must equal the module's bit for bit:

* its ring filled by 16-byte ``cp.async`` copies, every thread issuing a
  share of each tile's chunks (one commit group a tile), in place of one
  warp's bulk copies of whole rows;
* its move with up to 8 rows' loads in flight a thread before their
  stores;
* the grid's second half of blocks (on an H100 the second block of each
  SM) starting 3 us late, so that the two blocks of an SM do not reach
  their moves together.

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
V1 = "axial_attention_v1.cu"
V1_LOADS = [
    (V1, "  if (warp == 0 && blockIdx.x < ntiles) stage_tile(a, raw, bar, "
     "blockIdx.x);\n", ""),
    (V1, "    if (warp == 0 && next < ntiles) stage_tile(a, raw, bar, "
     "next);\n", ""),
    (V1, "    wf::mbar_wait(bar, parity);\n", "")]
V1_MOVE = [(V1, "    settle_tile(raw, qkv, c, nvalid * len, per_row, rows, "
            "r0, c0);\n", "")]
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
    "without its loads": V1_LOADS,
    "without its move into the fp32 layout": V1_MOVE,
    "without its staging": V1_LOADS + V1_MOVE,
}
# v1 variants -> edits, each output held to the module's bits
STAGE_CP = """// The cp.async variant of stage_tile: all threads, 16 B a copy.
template <typename T>
__device__ __forceinline__ void stage_cp(const V1Args<T>& a, T* raw,
                                         int tile) {
  constexpr int kVec = 16 / sizeof(T);
  const int c3 = 3 * a.c, chunks = c3 / kVec;
  const int s0 = tile * a.seqs, nvalid = min(a.seqs, a.nseq - s0);
  const wf::FastDiv by_chunks(chunks), by_len(a.len);
  for (int e = threadIdx.x; e < nvalid * a.len * chunks; e += blockDim.x) {
    const int p = by_chunks.div(e), ch = e - p * chunks;
    const int s = by_len.div(p), l = p - s * a.len;
    wf::cp_async16(raw + e * kVec, a.qkv + (seq_pos(a, s0 + s) +
                                            l * a.seq_stride) * c3 +
                                       ch * kVec);
  }
}

// The landed raw tile"""
VARIANTS = {
    "with cp.async 16-byte copies in place of the bulk copies": [
        (V1, "// The landed raw tile", STAGE_CP),
        (V1, "if (warp == 0 && blockIdx.x < ntiles) stage_tile(a, raw, bar, "
         "blockIdx.x);", "if (blockIdx.x < ntiles) stage_cp(a, raw, "
         "blockIdx.x);\n  wf::cp_async_commit();"),
        (V1, "    wf::mbar_wait(bar, parity);\n",
         "    wf::cp_async_wait<0>();\n"),
        (V1, "if (warp == 0 && next < ntiles) stage_tile(a, raw, bar, next);",
         "if (next < ntiles) stage_cp(a, raw, next);\n"
         "    wf::cp_async_commit();")],
    "with its move 8 rows in flight a thread": [(
        V1, """    for (int p = r0; p < npos; p += rows) {
      const uint4 u = *reinterpret_cast<const uint4*>(raw + p * c3 + col);
      const T* vals = reinterpret_cast<const T*>(&u);
      float* row = qkv + p * ldq;
#pragma unroll
      for (int k = 0; k < kVec; k += 4)
        *reinterpret_cast<float4*>(row + dst[k / 4]) =
            make_float4(wf::to_f(vals[k]), wf::to_f(vals[k + 1]),
                        wf::to_f(vals[k + 2]), wf::to_f(vals[k + 3]));
    }""", """    for (int p0 = r0; p0 < npos; p0 += 8 * rows) {
      uint4 u[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (p0 + i * rows < npos)
          u[i] = *reinterpret_cast<const uint4*>(raw + (p0 + i * rows) * c3
                                                 + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = p0 + i * rows;
        if (p >= npos) break;
        const T* vals = reinterpret_cast<const T*>(&u[i]);
        float* row = qkv + p * ldq;
#pragma unroll
        for (int k = 0; k < kVec; k += 4)
          *reinterpret_cast<float4*>(row + dst[k / 4]) =
              make_float4(wf::to_f(vals[k]), wf::to_f(vals[k + 1]),
                          wf::to_f(vals[k + 2]), wf::to_f(vals[k + 3]));
      }
    }""")],
    "with the grid's second half of blocks starting 3 us late": [(
        V1, "  int parity = 0;",
        "  if (2 * blockIdx.x >= gridDim.x) __nanosleep(3000);\n"
        "  int parity = 0;")],
}


def cut_builds():
    """{cut or variant: {lowering: CudaKernel}} for the libraries each
    changes, built in parallel from edited copies of ``csrc/``."""
    root = kbuild.BUILD_DIR / "ablations"
    nvcc = kbuild._nvcc()
    procs, out = [], {}
    for i, (cut, edits) in enumerate({**CUTS, **VARIANTS}.items()):
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
        whole = {low: runs[low]() for low in LIBRARIES}
        times = {(low, cut): [] for low, cut, _ in cases}
        for r in range(ROUNDS):
            for low, cut, k in cases:
                with swapped(low, k):
                    if r == 0 and cut in VARIANTS:
                        same = all(torch.equal(a, b) for a, b in
                                   zip(runs[low](), whole[low]))
                        if not same:
                            raise AssertionError(f"{low} {cut}: not the "
                                                 f"module's bits")
                    times[low, cut].append(time_ms(runs[low]))
        for low, cut, k in cases:
            if k is not None and k.launches == 0:
                raise AssertionError(f"{low} {cut}: the cut build never ran")
            line = (f"{shape} {low} {cut}: "
                    f"{statistics.median(times[low, cut]):.4f} ms (rounds "
                    + ", ".join(f"{t:.4f}" for t in times[low, cut]) + ")")
            if k is None:
                line += f"; max error / max|plain| {errs[low]:.3e}"
            elif cut in VARIANTS:
                line += "; the module's bits"
            print(line, flush=True)
        del x, qkvs, mid, plain, v1_plain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
