"""What bounds the ``logits_sums`` kernels on the card: ranges and variants.

    python3 logits_sums_sweep.py        # from the repo root, one CUDA card

Two tables of the forward and backward kernels of ``csrc/logits_sums.cu``
(the Gram form; ``ops/kernels/axial_attention_train.py::sums_plan`` sizes
them), in bf16, each case timed in 3 alternating rounds: the device's busy
time (``torch.profiler``), the time of a call replayed from a CUDA graph
(which the device paces, gaps between its launches included, where a
call's host time paces the CUDA events) and the CUDA-event time of a call,
medians of the rounds.  The script launches the kernels itself with plans
that it builds (``sums_plan_at``), so it can try any of them; the
package's globals and sources are not touched.

1. Ranges of positions a lane.  A (sequence, group) may be split over 1, 2
   or 4 ranges of positions, the ranges summed with shuffles
   (``sums_plan``: more where one range leaves SMs without a block).  Each
   attention axis alone, at every number of ranges its length allows: the
   flagship's (``[B, 15, 20, 64]``, 8 groups) and the MM-Fi model's
   (``[B, 17, 10, 64]``) at batch 256 (the train step that ``bench.py``
   and ``chip_smoke.py`` time) and at batch 64 (``TrainConfig``'s default),
   and 7 sequences at L = 20, 15, 10 and 17.  Each output is held to the
   plain version (2e-2 of its largest value, bf16 against fp32).
2. Design choices.  The kernels are built again from copies of ``csrc/``
   with one choice changed (``VARIANTS``), into
   ``wiflow_tpu_torch/build/sums_sweep/<n>/``, and timed beside the
   module's over both axes as a train step at batch 256 launches them,
   with the plan ``sums_plan`` gives:

   * the backward at 3 blocks an SM (at most 80 registers a thread: it
     spills) instead of 2;
   * the backward's second walk with 32 bytes of loads in flight a lane
     instead of 64;
   * the backward's second walk reading a copy of the lane's positions
     that the first walk made in shared memory with 16-byte ``cp.async``,
     instead of reading them again from L1 or L2;
   * the forward at 2 blocks an SM instead of 3, with 64 or 128 bytes of
     loads in flight a lane;
   * the forward's float64 sum of the blocks' partials by a second
     one-block launch instead of the last block to finish (the same sum,
     in the same order: the same bits).

   No variant changes the arithmetic of a (sequence, group), so each
   output is held to the module's bit for bit, the forward's within 1e-5
   where its grid, and so its partial sums, change.

The last lines are a summary of both tables, then the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys

import torch

from attention_ablations import loaded
from chip_smoke import TOL_BF16, device_ms, time_ms
from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
from wiflow_tpu_torch.ops.kernels import build as kbuild
from wiflow_tpu_torch.ops.kernels.build import dtype_code, ptr, sm_count

BATCHES = (256, 64)
RUNS = 20
ROUNDS = 3
SHAPES = {"flagship": (15, 20), "MM-Fi": (17, 10)}
SEVEN = (20, 15, 10, 17)
C, G = 64, 8
PARTS = (1, 2, 4)
SOURCE = "logits_sums.cu"
STAGE = """    if (n > 0) {
      // the lane's positions, copied to shared memory (rows of an odd
      // number of 16-byte units: no bank conflicts), then walked there
      extern __shared__ __align__(16) unsigned char stage[];
      const int units = kGC * (int)sizeof(T) / 16;
      const int span = ((a.len + (1 << a.parts_log2) - 1) >> a.parts_log2)
                       | 1;
      T* mine = reinterpret_cast<T*>(stage) +
                (size_t)threadIdx.x * span * units * (16 / sizeof(T));
      for (int i = 0; i < n; ++i)
        for (int w = 0; w < units; ++w)
          wf::cp_async16(mine + i * kGC + w * (16 / sizeof(T)),
                         src + (size_t)i * ld + w * (16 / sizeof(T)));
      wf::cp_async_commit();
      wf::cp_async_wait<0>();
      src = mine;
      ld = kGC;
    }
"""
LAUNCH = """    const int span = ((len + parts - 1) / parts) | 1;
    const size_t smem = (size_t)threads * span * kGC * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(
        sums_backward_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sums_backward_kernel<T><<<grid, threads, smem, st>>>(a);
"""
FORWARD_2 = ("constexpr int kForwardBlocksPerSm = 3;",
             "constexpr int kForwardBlocksPerSm = 2;")
SECOND_LAUNCH = [("""  // the last block to finish sums the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_partials(a.partial, gridDim.x, cols, a.sums);
  if (threadIdx.x == 0) *a.counter = 0;
}
""", """}

__global__ void __launch_bounds__(kThreads) sums_finish_kernel(
    const float* partial, int rows, int cols, float* sums) {
  sum_partials(partial, rows, cols, sums);
}
"""), ("  sums_forward_kernel<T><<<grid, threads, 0, st>>>(a);\n",
       "  sums_forward_kernel<T><<<grid, threads, 0, st>>>(a);\n"
       "  sums_finish_kernel<<<1, kThreads, 0, st>>>(a.partial, grid, "
       "2 * groups, a.sums);\n")]
# variant -> (kernel, blocks an SM in the grids, [(text, replacement)])
VARIANTS = {
    "backward at 3 blocks an SM": ("backward", (3, 3), [(
        "constexpr int kBackwardBlocksPerSm = 2;",
        "constexpr int kBackwardBlocksPerSm = 3;")]),
    "backward, walk 2 with 32 bytes of loads in flight": ("backward", None, [(
        "    walk<kLoadBytes>(src, ld, n, [&mo, dst, c]",
        "    walk<32>(src, ld, n, [&mo, dst, c]")]),
    "backward, walk 2 from a shared-memory copy": ("backward", None, [
        ("    int ld = a.ld;\n", "    int ld = a.ld;\n" + STAGE),
        ("    sums_backward_kernel<T><<<grid, threads, 0, st>>>(a);\n",
         LAUNCH)]),
    "forward at 2 blocks an SM": ("forward", (2, 2), [FORWARD_2]),
    "forward at 2 blocks an SM, 128 bytes of loads in flight": (
        "forward", (2, 2), [FORWARD_2, (
            "constexpr int kLoadBytes = 64;",
            "constexpr int kLoadBytes = 128;")]),
    "forward, the float64 sum by a second launch": (
        "forward", None, SECOND_LAUNCH),
}
KERNELS = {"forward": tk.SUMS_FORWARD, "backward": tk.SUMS_BACKWARD}


def variant_builds():
    """{variant: CudaKernel} built in parallel from edited copies of
    ``csrc/``."""
    root = kbuild.BUILD_DIR / "sums_sweep"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (name, (kind, _, edits)) in enumerate(VARIANTS.items()):
        src = root / str(i)
        shutil.copytree(kbuild.CSRC_DIR, src)
        path = src / SOURCE
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to change is not once "
                                   f"in {SOURCE}")
            text = text.replace(old, new)
        path.write_text(text)
        lib = src / "liblogits_sums.so"
        procs[name] = (kind, lib, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (kind, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc, {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas, {name}: {line.strip()}")
        out[name] = loaded(KERNELS[kind], lib)
    return out


def forward(kern, q, k, plan):
    """``kern`` (the forward kernel or a build of it) with ``plan``, as
    ``logits_sums_forward`` launches it."""
    (q, k), ld = tk._rows((q, k), ("q", "k"))
    n, length, c = q.shape
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    partial, counter = tk._workspace(q.device, stream, plan.grid, 2 * G)
    sums = torch.empty((2, G), device=q.device, dtype=torch.float32)
    kern.launch(dtype_code(q.dtype), ptr(q), ptr(k), ld, n, length, c, G,
                plan.parts, plan.seqs, plan.threads, plan.grid, ptr(partial),
                ptr(counter), ptr(sums), ctypes.c_void_p(stream))
    return sums


def backward(kern, q, k, dsums, plan):
    """``kern`` (the backward kernel or a build of it) with ``plan``, as
    ``logits_sums_backward`` launches it."""
    (q, k), ld = tk._rows((q, k), ("q", "k"))
    n, length, c = q.shape
    dq, dk = (torch.empty_like(q, memory_format=torch.contiguous_format)
              for _ in range(2))
    kern.launch(dtype_code(q.dtype), ptr(q), ptr(k), ld, ptr(dsums), ptr(dq),
                ptr(dk), n, length, c, G, plan.parts, plan.seqs,
                plan.threads, plan.backward_grid,
                kbuild.stream_ptr(q.device))
    return dq, dk


def run(kind, kern, args, plans):
    """A call over ``args`` [(q, k, dsums)], one plan each."""
    if kind == "forward":
        return [forward(kern, q, k, p) for (q, k, _), p in zip(args, plans)]
    return [t for (q, k, d), p in zip(args, plans)
            for t in backward(kern, q, k, d, p)]


CAPTURE = None


def graph_ms(fn, calls: int = 20) -> float:
    """ms a call of ``fn()``, ``calls`` of them captured in a CUDA graph and
    replayed: the device's pace, the gaps between launches included.  An
    eager call on the capture stream first makes the forward's workspace
    there."""
    global CAPTURE
    CAPTURE = CAPTURE or torch.cuda.Stream()
    CAPTURE.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(CAPTURE):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=CAPTURE):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return time_ms(graph.replay, RUNS) / calls


def timings(fn):
    return device_ms(fn), graph_ms(fn), time_ms(fn, RUNS)


def inputs(gen, dev, n, length):
    qkv = torch.randn((n, length, 3 * C), generator=gen,
                      device=dev).to(torch.bfloat16)
    dsums = torch.randn((2, G), generator=gen, device=dev)
    return (*qkv.split(C, dim=-1)[:2], dsums)


def report(what, rounds):
    med = [statistics.median(x) for x in zip(*rounds)]
    print(f"{what}: device busy {med[0]:.4f} ms, from a CUDA graph "
          f"{med[1]:.4f} ms, CUDA events {med[2]:.4f} ms (rounds, "
          f"busy/graph/events " + ", ".join(
              "/".join(f"{x:.4f}" for x in r) for r in rounds) + ")",
          flush=True)
    return med


def range_shapes():
    """(label, short label, sequences, length) of each attention axis of
    table 1."""
    out = []
    for batch in BATCHES:
        for model, (h, w) in SHAPES.items():
            out += [(f"{model} {axis}, batch {batch}",
                     f"{model[:2]} {axis[0]} {batch}", n, length)
                    for axis, n, length in (("width", batch * h, w),
                                            ("height", batch * w, h))]
    return out + [(f"L={length}, 7 seqs", f"7 seqs L={length}", 7, length)
                  for length in SEVEN]


def ranges_table(gen, dev, sms):
    """Table 1.  Returns its summary lines."""
    summary = []
    for label, short, n, length in range_shapes():
        q, k, d = inputs(gen, dev, n, length)
        planned = tk.sums_plan(n, length, C, G, torch.bfloat16, sms).parts
        qf, kf = (t.float().requires_grad_(True) for t in (q, k))
        sums = tk.logits_sums_plain(qf, kf, G)
        ref = [sums.detach(), *torch.autograd.grad(sums, (qf, kf), d)]
        parts = [p for p in PARTS if p <= length]
        cases = [(kind, p) for p in parts for kind in KERNELS]
        times = {case: [] for case in cases}
        for _ in range(ROUNDS):
            for kind, p in cases:
                plan = [tk.sums_plan_at(n, G, p, sms)]
                fn = lambda: run(kind, KERNELS[kind], [(q, k, d)],  # noqa
                                 plan)
                want = ref[1:] if kind == "backward" else ref[:1]
                for x, y in zip(fn(), want):
                    err = (x.float() - y).abs().max().item()
                    if not err <= TOL_BF16 * y.abs().max().item():
                        raise AssertionError(f"{label} {kind} at {p} "
                                             f"ranges: {err}")
                times[kind, p].append(timings(fn))
        best = {}
        for kind, p in cases:
            med = report(f"ranges, {label} (n={n}, L={length}) {kind}, {p} "
                         f"ranges a lane{' (planned)' if p == planned else ''}",
                         times[kind, p])
            best.setdefault(kind, []).append((med, p))
        for kind, meds in best.items():
            summary.append(f"{short} {kind[:3]} P={planned}: " + " ".join(
                f"{p}:{m[0]:.4f}" for m, p in meds))
    return summary


def variants_table(gen, dev, sms, variants):
    """Table 2.  Returns its summary lines."""
    summary = []
    for shape, (h, w) in SHAPES.items():
        args = [inputs(gen, dev, n, length)
                for n, length in ((BATCHES[0] * h, w), (BATCHES[0] * w, h))]
        plans = [tk.sums_plan(q.shape[0], q.shape[1], C, G, torch.bfloat16,
                              sms) for q, _, _ in args]
        cases = [(kind, kern, None) for kind, kern in KERNELS.items()]
        cases += [(name, kern, VARIANTS[name]) for name, kern in
                  variants.items()]
        times = {name: [] for name, _, _ in cases}
        for _ in range(ROUNDS):
            for name, kern, variant in cases:
                kind, blocks, _ = variant or (name, None, None)
                mine = plans if blocks is None else [p._replace(
                    grid=min(p.tiles, blocks[0] * sms),
                    backward_grid=min(p.tiles, blocks[1] * sms))
                    for p in plans]
                ref = run(kind, KERNELS[kind], args, plans)
                got = run(kind, kern, args, mine)
                if not all(torch.equal(x, y) if blocks is None or
                           kind == "backward" else
                           torch.allclose(x, y, rtol=1e-5, atol=0)
                           for x, y in zip(got, ref)):
                    raise AssertionError(f"{shape} {name}: other results")
                times[name].append(timings(
                    lambda: run(kind, kern, args, mine)))  # noqa: B023
        meds = [report(f"variants, {shape} {name}, {plans[0].parts} ranges "
                       f"a lane", times[name]) for name, _, _ in cases]
        summary.append(f"{shape}: " + ", ".join(
            f"{name[:3] if i < len(KERNELS) else i - len(KERNELS)} "
            f"{m[0]:.4f}/{m[1]:.4f}" for i, ((name, _, _), m) in
            enumerate(zip(cases, meds))))
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("logits_sums_sweep: no CUDA device")
    dev = torch.device("cuda")
    sms = sm_count(0)
    kbuild.build(["logits_sums"])
    variants = variant_builds()
    gen = torch.Generator(device=dev).manual_seed(12)
    ranges = ranges_table(gen, dev, sms)
    table2 = variants_table(gen, dev, sms, variants)
    for name, k in variants.items():
        if k.launches == 0:
            raise AssertionError(f"{name}: the variant never ran")
    print("table 1, the planned P; P: device busy ms")
    print("\n".join("  " + line for line in ranges))
    print("table 2, the module's kernels and the variants by their number "
          "in VARIANTS: device busy / from a CUDA graph, ms")
    print("\n".join("  " + line for line in table2))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
