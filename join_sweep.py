"""What bounds the ``join`` kernels on the card: variants and ablations.

    python3 join_sweep.py        # from the repo root, one CUDA card

The forward and backward kernels of ``csrc/join_fused.cu``
(``ops/kernels/stage_fused.py::join_plan`` sizes them) at the 9 joins of
the fused train step at batch 256 in bf16, as ``chip_smoke.py`` phase 10
times them, against builds of edited copies of ``csrc/`` with one choice
changed (``VARIANTS``), into ``wiflow_tpu_torch/build/join_sweep/<n>/``:

* bf16 conversions one at a time (``cvt.rn.bf16.f32``) instead of in
  pairs (``cvt.rn.bf16x2.f32``): the same bits;
* the forward at 2 blocks an SM everywhere (the module takes 3 where a
  chunk is at most 8 bytes): the same bits;
* every thread fencing its writes before the block's count (the module:
  thread 0 after the block's barrier): the same bits;
* the backward at 2 blocks an SM (the module takes 3, at most 85
  registers a thread): the same bits;
* 3 and 4 stages (rows a thread has in flight, the one it computes
  included) instead of 2: the same bits;
* the backward in the forward's chunks (8 channels in bf16) instead of at
  most 4, with the module's build (its 32 fp32 sums a thread spill at
  128 registers): the same bits;
* the backward cut in slices until a finish sums at most 4,096 or 8,192
  partials instead of 2,048 (fewer slices, longer finishes): the same
  bits;
* ablation, no rounding to bf16 between the steps (other bits);
* ablation, no element math: ``out = h + res``, ``gh = go + h``,
  ``gres = go + res`` (other bits): the floor of the loads and stores;
* ablation, the backward without its finish (the blocks' partials
  written, no count and no ``gvec``), and without its block sums too (so
  without the fp32 sums a thread keeps).

Each case runs through the module's own wrappers (``join_forward``,
``join_backward``, the kernel swapped for the build), with the plan the
variant needs, in 3 alternating rounds; per launch the device's busy time
(``torch.profiler``), median of the rounds.  The variants that keep the
arithmetic are held to the module's outputs bit for bit (``out``, ``gh``,
``gres``; the per-channel sums within 1e-5 of their largest where the
grid changes).  The last lines are a summary, then the card's name and
power limit.
"""

from __future__ import annotations

import contextlib
import math
import shutil
import statistics
import subprocess
import sys

import torch

from attention_ablations import loaded
from chip_smoke import device_ms, join_inputs
from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.ops.kernels import build as kbuild
from wiflow_tpu_torch.ops.kernels import stage_fused as sk

BATCH = 256
ROUNDS = 3
SOURCE = "join_fused.cu"
DT = torch.bfloat16
PLAN = sk.join_plan         # the module's, kept while a variant's is in use
NO_MATH_FWD = (
    "    float v[V], r[V];\n    from_chunk(v, x[0]);\n",
    "    float v[V], r[V];\n"
    "    if (j.npos > 0) {\n"
    "      from_chunk(v, x[0]);\n      from_chunk(r, x[1]);\n"
    "#pragma unroll\n      for (int k = 0; k < V; ++k) v[k] += r[k];\n"
    "      *reinterpret_cast<Chunk<T, V>*>(j.out + e) = to_chunk<T>(v);\n"
    "      return;\n    }\n"
    "    from_chunk(v, x[0]);\n")
NO_MATH_BWD = (
    "      float uh[V], sig_h[V], v[V], g[V];\n",
    "      float uh[V], sig_h[V], v[V], g[V];\n"
    "      if (j.npos > 0) {\n"
    "        from_chunk(uh, x[0]);\n        from_chunk(v, x[1]);\n"
    "        from_chunk(g, x[2]);\n"
    "#pragma unroll\n        for (int k = 0; k < V; ++k) {\n"
    "          uh[k] += g[k];\n          v[k] += g[k];\n"
    "          acc[k][0] += g[k];\n        }\n"
    "        *reinterpret_cast<Chunk<T, V>*>(j.gh + e) = to_chunk<T>(uh);\n"
    "        *reinterpret_cast<Chunk<T, V>*>(j.gres + e) = to_chunk<T>(v);\n"
    "        return;\n      }\n")
# variant -> (same bits, plan change, [(text, replacement)])
VARIANTS = {
    "conversions one at a time": (True, None, [(
        "constexpr bool kPairs = true;", "constexpr bool kPairs = false;")]),
    "forward at 2 blocks an SM": (True, "fwd2", [(
        "  return V * (int)sizeof(T) <= 8 ? 3 : 2;",
        "  return 2;")]),
    "every thread fences its writes": (True, None, [(
        "  __syncthreads();\n  if (t == 0) {\n    __threadfence();\n",
        "  __threadfence();\n  __syncthreads();\n  if (t == 0) {\n")]),
    "backward at 2 blocks an SM": (True, "bwd2", [(
        "  return V <= 4 ? 3 : 2;", "  return 2;")]),
    "3 stages": (True, 3, [(
        "constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    "4 stages": (True, 4, [(
        "constexpr int kStages = 2;", "constexpr int kStages = 4;")]),
    "backward in chunks of 8 channels": (True, "bwd8", []),
    "backward finish at 4,096 partials": (True, 4096, []),
    "backward finish at 8,192 partials": (True, 8192, []),
    "ablation: no rounding between steps": (False, None, [(
        "  if constexpr (sizeof(T) == 2 && kPairs) {\n#pragma unroll\n"
        "    for (int k = 0; k + 1 < V; k += 2) {\n      const float2 f =",
        "  if constexpr (false) {\n#pragma unroll\n"
        "    for (int k = 0; k + 1 < V; k += 2) {\n      const float2 f ="), (
        "  } else {\n#pragma unroll\n    for (int k = 0; k < V; ++k) x[k] = "
        "round_to<T>(x[k]);\n  }",
        "  }")]),
    "ablation: no element math": (False, None, [NO_MATH_FWD, NO_MATH_BWD]),
    "ablation: backward without its finish": (False, None, [(
        "  // the last block of the slice to finish sums the slice's partials:",
        "  if (j.npos > 0) return;\n"
        "  // the last block of the slice to finish sums the slice's partials:"
        )]),
    "ablation: backward without its block sums and finish": (False, None, [(
        "  // the block's row lanes, in a fixed order: `parts` strided ranges"
        " of\n", "  if (j.npos > 0) return;\n  // the block's row lanes, in "
        "a fixed order: `parts` strided ranges of\n")]),
}


def replan(plan: sk.JoinPlan, how, npos: int, c: int, backward: bool,
           sms: int) -> sk.JoinPlan:
    """The plan a variant's build needs: ``"fwd2"`` and ``"bwd2"``, the
    forward's or the backward's grid at 2 blocks an SM; ``"bwd8"``, the
    backward in the forward's chunks; 4096 or 8192, the backward cut in
    slices until a finish sums at most that many partials; 3 or 4, that
    many stages."""
    if (how == "fwd2" and not backward) or (how == "bwd2" and backward):
        return plan._replace(grid=min(-(-npos // plan.rows),
                                      -(-int(how[-1]) * sms // plan.slices)))
    if (how == "bwd8" or how in (4096, 8192)) and backward:
        wide = how == "bwd8"            # the forward's chunks, or a cap
        cap = 2048 if wide else how
        vec = PLAN(npos, c, DT, not wide, sms).vec
        groups = c // vec
        q = None
        for slices in range(1, groups + 1):
            cols = -(-groups // slices)
            if q is not None and cols * vec * 2 < 32:
                break                   # not below a sector of a row
            if cols * vec > 256:
                continue
            rows, slices = 256 // cols, -(-groups // cols)
            blocks = sk.join_blocks_per_sm(vec, 2, True)
            q = plan._replace(vec=vec, groups=groups, cols=cols,
                              slices=slices, rows=rows, threads=rows * cols,
                              grid=min(-(-npos // rows),
                                       -(-blocks * sms // slices)))
            if q.grid * cols * vec <= cap:
                break
        return q
    return plan._replace(stages=how) if how in (3, 4) else plan


def variant_builds():
    """{variant: (forward, backward CudaKernel)} built in parallel from
    edited copies of ``csrc/``."""
    root = kbuild.BUILD_DIR / "join_sweep"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (name, (_, _, edits)) in enumerate(VARIANTS.items()):
        if not edits:
            continue
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
        lib = src / "libjoin_fused.so"
        procs[name] = (lib, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc, {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas, {name}: {line.strip()}")
        out[name] = (loaded(sk.JOIN_FORWARD, lib),
                     loaded(sk.JOIN_BACKWARD, lib))
    lib = kbuild.library_path("join_fused")
    for name, (_, _, edits) in VARIANTS.items():
        if not edits:
            out[name] = (loaded(sk.JOIN_FORWARD, lib),
                         loaded(sk.JOIN_BACKWARD, lib))
    return out


@contextlib.contextmanager
def swapped(kernels, how, sms):
    """The module's join kernels and plan replaced by a variant's."""
    keep = sk.JOIN_FORWARD, sk.JOIN_BACKWARD
    sk.JOIN_FORWARD, sk.JOIN_BACKWARD = kernels or keep
    sk.join_plan = lambda npos, c, dt, bwd: replan(
        PLAN(npos, c, dt, bwd), how, npos, c, bwd, sms)
    try:
        yield
    finally:
        (sk.JOIN_FORWARD, sk.JOIN_BACKWARD), sk.join_plan = keep, PLAN


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("join_sweep: no CUDA device")
    dev = torch.device("cuda")
    sms = kbuild.sm_count(0)
    kbuild.build(["join_fused"])
    variants = variant_builds()
    cfg = ModelConfig()
    keep = 1.0 - cfg.dropout
    _, joins = sk.step_launches(cfg, BATCH)
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = []
    for c in joins:
        i = join_inputs(c, gen, dev, keep)
        args = [i["h"].to(DT), *i["vh"], i["mask"], i["res"].to(DT),
                *i["vr"]]
        kw = dict(keep=keep, act_h=c["act_h"])
        cases.append((c, (lambda a=args, kw=kw: sk.join_forward(*a, **kw)),
                      (lambda a=args, g=i["go"].to(DT), kw=kw:
                       sk.join_backward(*a, g, **kw))))
    names = ["module", *VARIANTS]
    kernels = {"module": None, **variants}
    ref = {}
    times = {(n, k): [] for n in names for k in range(len(cases))}
    for _ in range(ROUNDS):
        for name in names:
            same, how, _ = VARIANTS.get(name, (True, None, None))
            with swapped(kernels[name], how, sms):
                for k, (c, fwd, bwd) in enumerate(cases):
                    out, gh, gres, gvec = fwd(), *bwd()
                    got = [out, gh, gres, gvec[:2 if c["res_norm"] else 1]]
                    if name == "module":
                        ref[k] = got
                    elif same:
                        for a, b in zip(got[:3], ref[k][:3]):
                            if not torch.equal(a, b):
                                raise AssertionError(f"{name}: other bits")
                        err = (got[3] - ref[k][3]).abs().max()
                        if not err <= 1e-5 * ref[k][3].abs().max():
                            raise AssertionError(f"{name}: other sums")
                    times[name, k].append((device_ms(fwd), device_ms(bwd)))
    for name in names[1:]:
        for kern in kernels[name]:
            if kern.launches == 0:
                raise AssertionError(f"{name}: the variant never ran")
    summary = []
    for name in names:
        meds = [tuple(statistics.median(x) for x in zip(*times[name, k]))
                for k in range(len(cases))]
        print(f"{name}: device busy fwd / bwd per launch, ms")
        for (c, _, _), (f, b) in zip(cases, meds):
            p, q = (sk.join_plan(math.prod(c["lead"]), c["c"], DT, bwd)
                    for bwd in (False, True))
            print(f"  join {list(c['lead'])} x {c['c']} [v {p.vec} / "
                  f"{q.vec}, {p.slices} / {q.slices} slice(s)]: {f:.4f} / "
                  f"{b:.4f}")
        tf, tb = (sum(m[w] for m in meds) for w in (0, 1))
        summary.append(f"{name}: fwd {tf:.4f} bwd {tb:.4f} ms over the "
                       f"step's 9 launches")
    print("summary, device busy: " + "; ".join(summary))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
