"""One run of one cell: set-up, the measured window, the traced
sub-window, the comparison with the reference, and the result line.

A cell is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its traffic generator
(``traffic/<generator>.py``, which builds the inputs and the system under
test and drives the closed loop), the generator's parameters, and the
limits of its comparison.  Which metrics a cell reports is read from
``BENCHMARK.json``; each per-layer metric is ``metrics/<metric>.json``,
read by the reader module that file names (``metrics/<reader>.py``).
Adding a cell, a configuration or a metric is adding such files and
entries.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import torch

from benchmark import devtrace, weights

LOADED = time.perf_counter()     # torch and the benchmark are imported
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wiflow_tpu")


def load_json(path: Path):
    return json.loads(path.read_text())


def metrics_of(bench: Mapping, cell: str):
    """(end-to-end, per-layer) metric entries the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_cell(name: str) -> Dict:
    """The cell ``name``: its file, its configuration, its entry in
    ``BENCHMARK.json`` and the metrics it reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(HERE / "workloads" / f"{name}.json")
    cfg = load_json(HERE / "configs" / f"{entry['config']}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise SystemExit(f"{name}: BENCHMARK.json and workloads/{name}.json "
                         f"disagree on the configuration or the traffic")
    e2e, layer = metrics_of(bench, name)
    return dict(cell, name=name, chips=entry["chips"], cfg=cfg,
                end_to_end=e2e, per_layer=layer)


class Spans:
    """The benchmark's own spans (host seconds by name) and counters, taken
    around its calls into the program, while ``on``."""

    def __init__(self):
        self.on = True
        self.reset()

    def reset(self) -> None:
        self.seconds: Dict[str, List[float]] = {}
        self.counts: Dict[str, float] = {}
        self.rows: List[int] = []    # every call's rows, also while off

    def call(self, name: str, rows: int, seconds: float) -> None:
        """A call into the served forward: its host seconds (``name``)
        and its rows (``<name>.rows``)."""
        self.rows.append(rows)
        self.add(name, seconds)
        self.count(f"{name}.rows", rows)

    def add(self, name: str, seconds: float) -> None:
        if self.on:
            self.seconds.setdefault(name, []).append(seconds)

    def count(self, name: str, n: float) -> None:
        if self.on:
            self.counts[name] = self.counts.get(name, 0) + n


class Ctx:
    """What a traffic generator is handed."""

    def __init__(self, cell: Mapping, seed: int, device: torch.device,
                 t0: float, program=None):
        self.cell, self.cfg, self.seed = cell, cell["cfg"], seed
        self.params = cell["params"]
        self.device = device
        self.spans = Spans()
        # set-up by phase: importing torch and the benchmark (in a process
        # that runs one cell), finding the card, importing the program, ...
        self._mark = time.perf_counter()
        self.phases: Dict[str, float] = {
            "imports": max(LOADED - t0, 0.0),
            "cuda": self._mark - max(LOADED, t0)}
        if program is None:
            from benchmark import program
        self.program = program
        self.phase("program_import")

    def seed_for(self, tag: str) -> int:
        """A seed of its own for each draw, from the run's seed."""
        h = hashlib.sha256(f"{self.seed}:{tag}".encode()).digest()
        return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)

    def phase(self, name: str) -> None:
        """Seconds of set-up since the last phase, by name."""
        t = time.perf_counter()
        self.phases[name] = t - self._mark
        self._mark = t

    def weights(self) -> Dict[str, torch.Tensor]:
        """The configuration's weights, drawn from the seed on the device."""
        return weights.draw(self.cfg, self.seed_for("weights"), self.device)


class Reading:
    """What a per-layer metric's reader reads."""

    def __init__(self, ctx: Ctx, e2e: Mapping[str, float],
                 trace: Optional[devtrace.Trace], launches: Mapping[str, int],
                 traced: Mapping):
        self.cell, self.cfg = ctx.cell, ctx.cfg
        self.spans = ctx.spans
        self.e2e, self.trace = e2e, trace
        self.launches, self.traced = launches, traced
        self.notes: Dict[str, object] = {}   # printed before the result


def read_metric(entry: Mapping, reading: Reading) -> Optional[float]:
    spec = load_json(HERE / "metrics" / f"{entry['name']}.json")
    reader = importlib.import_module(f"benchmark.metrics.{spec['reader']}")
    return reader.read(spec, reading)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0] if out else None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def pace(e2e: Mapping[str, float], traced: Mapping, tr: devtrace.Trace
         ) -> Dict[str, float]:
    """Windows a second in the traced sub-window (its windows over the
    trace's window) against the untraced rate: how far tracing slows the
    work it measures."""
    rate = next((v for k, v in e2e.items() if k.endswith("windows_per_s")),
                None)
    got = traced.get("windows", 0) / tr.window_s if tr.window_s > 0 else 0
    return {"untraced_windows_per_s": rate, "traced_windows_per_s": got,
            "traced_over_untraced": got / rate if rate else None}


def run_cell(cell: Mapping, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, program=None) -> Dict:
    """Set-up, window, check.  Returns the result line's object."""
    ctx = Ctx(cell, seed, device, t0, program)
    if device.type == "cuda":
        ctx.program.build_kernels(cell["kernels"])
    ctx.phase("kernels")
    gen = importlib.import_module(f"benchmark.traffic.{cell['generator']}")
    drv = gen.setup(ctx)
    setup_s = time.perf_counter() - t0
    traced: Dict = {}
    tr = None
    launches: Dict[str, int] = {}
    if trace:
        sub = cell["trace"]
        e2e = drv.run(max(seconds - sub.get("seconds", 0), 1.0))
        ctx.spans.on = False
        before = ctx.program.launches()
        tr = devtrace.capture(lambda: traced.update(drv.traced(sub)))
        after = ctx.program.launches()
        launches = {k: after[k] - before[k] for k in after}
        traced["pace"] = pace(e2e, traced, tr)
    else:
        e2e = drv.run(seconds)
    e2e["setup_s"] = setup_s
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    drv.free()
    attempted, failed = drv.attempted, drv.failed
    found, info = drv.check()
    limits = cell["check"]["limits"]
    checks = {k: found[k] for k in limits}
    info = dict({k: v for k, v in found.items() if k not in limits},
                **info, setup=ctx.phases)
    # a request that failed, or a step whose loss is not finite, is wrong
    correct = failed == 0 and all(math.isfinite(v) and v <= limits[k]
                                  for k, v in checks.items())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    out: Dict = {"correct": correct, "attempted": attempted,
                 "failed": failed}
    if trace:
        reading = Reading(ctx, e2e, tr, launches, traced)
        metrics = {}
        for m in cell["per_layer"]:
            v = read_metric(m, reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["metrics"] = metrics
        out["device"] = dev
        out["breakdown"] = tr.breakdown()
        out["notes"] = dict(reading.notes, pace=traced["pace"])
    else:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell["end_to_end"]}
        out["device"] = dev
    out["info"] = info
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in checks.items()}
    return out


def main(args, t0: float) -> int:
    cell = load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"{args.workload}: needs {cell['chips']} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t0)
    notes = out.pop("notes", None)
    if notes:
        print("traced: " + json.dumps(notes))
    print("reported, not compared: " + json.dumps(out.pop("info")),
          file=sys.stderr)
    leaked = forbidden_modules()
    if leaked:
        print(f"modules of JAX or the JAX package were loaded: {leaked}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
