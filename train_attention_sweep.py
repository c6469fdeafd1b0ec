"""Tile sizes of the train attention core on the card, and what its
backward's first pass over the keys costs.

    python3 train_attention_sweep.py      # from the repo root, one CUDA card

``ops/kernels/axial_attention_train.py::train_attention_plan`` cuts the
sequences of ``axial_core`` into tiles of at most ``_FORWARD_POSITIONS`` /
``_BACKWARD_POSITIONS`` positions.  This script times the forward and the
backward kernel (``csrc/axial_core.cu``) over both attention axes as one
train step launches them, at batch 256 in bf16, for the flagship
(``[256, 15, 20, 64]``, 8 groups) and the MM-Fi model (``[256, 17, 10,
64]``), with each tile size of ``POSITIONS`` in place of the module's, in
3 alternating rounds: the device's busy time (``torch.profiler``) and the
CUDA-event time of a call, medians of the rounds.  Each size's output is
held to the module's own plan's bit for bit where the tile size does not
change the arithmetic (out, dq, dk and dv: a row's sums do not depend on
the tile), so a plan that the C side mislays shows here.

It also builds copies of ``csrc/`` with a stage of a kernel cut out
(``CUTS``; the output is then meaningless and not checked) into
``wiflow_tpu_torch/build/sweep/<n>/`` and times them beside the whole
kernels at the module's tile sizes: what each stage costs (the copies
from device memory, each pass of the backward).  Cutting the
backward's first pass over the keys (the softmax's max, denominator and
t) bounds what saving the forward's log-sum-exp for the backward could
gain.  The package's sources are not touched.  The last line is the
card's name and power limit.
"""

from __future__ import annotations

import shutil
import statistics
import subprocess
import sys

import torch

from attention_ablations import loaded
from chip_smoke import device_ms, time_ms
from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
from wiflow_tpu_torch.ops.kernels import build as kbuild

BATCH = 256
RUNS = 20
ROUNDS = 3
SHAPES = {"flagship": (15, 20), "MM-Fi": (17, 10)}
C, G = 64, 8
POSITIONS = (80, 60, 48, 40, 30)
# cut -> (kernel, [(text of csrc/axial_core.cu, replacement)])
CUTS = {
    "backward without its loads from device memory": ("backward", [(
        "      wf::cp_async16(raw + e * kVec, source(a, (size_t)s0 * a.len, "
        "chunk(e)));\n", "")]),
    "backward without its first pass over the keys": ("backward", [(
        "  for (int j0 = 0; j0 < len; j0 += kChunk) {\n"
        "    float l[kQ][kChunk]",
        "  for (int j0 = 0; j0 < 0; j0 += kChunk) {\n"
        "    float l[kQ][kChunk]")]),
    "backward without pass 1": ("backward", [(
        "      terms[e] = row_pass(a, rows, stats, s0, s, qb, g);",
        "      terms[e] = 0.f;")]),
    "backward without pass 2": ("backward", [(
        "      column_pass(a, rows, stats, s0, s, kp, g);\n", "")]),
    "forward without its loads from device memory": ("forward", [(
        "          raw[b] = *reinterpret_cast<const uint4*>(source(a, p0, "
        "ch));", "          raw[b] = make_uint4(0, 0, 0, 0);")]),
}
ATTRS = {"forward": "CORE_FORWARD", "backward": "CORE_BACKWARD"}


def cut_builds():
    """{cut: CudaKernel} built in parallel from edited copies of
    ``csrc/``."""
    root = kbuild.BUILD_DIR / "sweep"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (cut, (kind, edits)) in enumerate(CUTS.items()):
        src = root / str(i)
        shutil.copytree(kbuild.CSRC_DIR, src)
        path = src / "axial_core.cu"
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{cut}: the text to cut is not once in "
                                   f"axial_core.cu")
            text = text.replace(old, new)
        path.write_text(text)
        lib = src / "libaxial_core.so"
        procs[cut] = (kind, lib, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for cut, (kind, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc, {cut}:\n{log}")
        out[cut] = loaded(getattr(tk, ATTRS[kind]), lib)
    return out


def with_positions(fwd: int, bwd: int):
    tk._FORWARD_POSITIONS, tk._BACKWARD_POSITIONS = fwd, bwd
    tk.train_attention_plan.cache_clear()


def outputs(kind, got):
    """The outputs that the tile size must not change: out, or dq, dk, dv
    (dscale's partial sums follow the tiles)."""
    return got if kind == "forward" else [t for r in got for t in r[:3]]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("train_attention_sweep: no CUDA device")
    dev = torch.device("cuda")
    kbuild.build(["axial_core"])
    cuts = cut_builds()
    default = {"forward": tk._FORWARD_POSITIONS,
               "backward": tk._BACKWARD_POSITIONS}
    gen = torch.Generator(device=dev).manual_seed(11)
    for shape, (h, w) in SHAPES.items():
        args = []
        for n, length in ((BATCH * h, w), (BATCH * w, h)):
            qkv = torch.randn((n, length, 3 * C), generator=gen,
                              device=dev).to(torch.bfloat16)
            scale = torch.empty(G, device=dev).uniform_(0.25, 0.45,
                                                        generator=gen)
            dout = torch.randn((n, length, C), generator=gen,
                               device=dev).to(torch.bfloat16)
            args.append((*qkv.split(C, dim=-1), scale, dout))
        runs = {
            "forward": lambda: [tk.axial_core_forward(*a[:4]) for a in args],
            "backward": lambda: [tk.axial_core_backward(*a) for a in args]}
        with_positions(default["forward"], default["backward"])
        ref = {kind: outputs(kind, fn()) for kind, fn in runs.items()}
        cases = [(kind, p, None) for kind in runs for p in POSITIONS]
        cases += [(cut, default[CUTS[cut][0]], k) for cut, k in cuts.items()]
        times = {case[:2]: ([], []) for case in cases}
        for _ in range(ROUNDS):
            for kind, p, cut in cases:
                base = kind.split()[0]
                with_positions(p if base == "forward" else default["forward"],
                               p if base == "backward" else
                               default["backward"])
                attr = ATTRS[base]
                keep = getattr(tk, attr)
                setattr(tk, attr, cut or keep)
                try:
                    if cut is None and not all(
                            torch.equal(x, y) for x, y in zip(
                                outputs(kind, runs[kind]()), ref[kind])):
                        raise AssertionError(f"{shape} {kind} at {p} "
                                             f"positions: other bits")
                    times[kind, p][0].append(device_ms(runs[base]))
                    times[kind, p][1].append(time_ms(runs[base], RUNS))
                finally:
                    setattr(tk, attr, keep)
        with_positions(default["forward"], default["backward"])
        for kind, p, _ in cases:
            busy, events = times[kind, p]
            print(f"{shape} {kind}, tiles of at most {p} positions: device "
                  f"busy {statistics.median(busy):.4f} ms, CUDA events "
                  f"{statistics.median(events):.4f} ms (rounds, busy/events "
                  + ", ".join(f"{b:.4f}/{e:.4f}" for b, e in zip(busy, events))
                  + ")", flush=True)
        for length, n in ((w, BATCH * h), (h, BATCH * w)):
            plan = tk.train_attention_plan(n, length, C, G, torch.bfloat16,
                                           kbuild.sm_count(0))
            print(f"{shape} L={length}: the module's plan {plan}")
    for cut, k in cuts.items():
        if k.launches == 0:
            raise AssertionError(f"{cut}: the cut build never ran")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
