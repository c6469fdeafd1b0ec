"""Uploads of recorded CSI: one client in a closed loop, each request a
contiguous slice of a stream store on the device, served by the
program's stream layer and copied back to the host as pose tracks.

Parameters (``params`` of the cell file):

* ``store_frames``: frames of the store, ``[frames, subcarriers]`` fp32,
  standard normal, drawn from the seed on the device in one call;
* ``frames``: the request lengths in frames, the same list for every
  seed; each seed serves them in its own order, cycle after cycle, each
  from an offset drawn from the seed;
* ``batch``, ``options``: the stream layer's batch and the served
  forward's options (:func:`benchmark.program.server`);
* ``check_every``: one request in so many (from a phase drawn from the
  seed) is kept and compared with the reference after the window.

Every request's latency runs from its submission to its poses on the
host.  Useful windows are ``frames - window + 1`` a request; the padding
the stream layer adds to fill its last batch is counted apart.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Iterator, List, Tuple

import torch

from benchmark import checks
from benchmark.reference import model as ref


def requests(p, seed: int) -> Iterator[Tuple[int, int]]:
    """(offset, frames) of each request, cycle after cycle."""
    rng = random.Random(seed)
    base = list(p["frames"])
    while True:
        order = base[:]
        rng.shuffle(order)
        for n in order:
            yield rng.randrange(p["store_frames"] - n + 1), n


class Stream:
    def __init__(self, ctx):
        self.ctx, p, cfg = ctx, ctx.params, ctx.cfg
        self.window = cfg["window_size"]
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed_for("store"))
        self.store = torch.randn((p["store_frames"], cfg["num_subcarriers"]),
                                 generator=gen, device=ctx.device)
        ctx.phase("store")
        self.sd = ctx.weights()
        ctx.phase("weights")
        self.infer = ctx.program.stream_server(
            self.sd, cfg, p["batch"], p.get("options", {}), ctx.spans,
            ctx.device)
        ctx.phase("program")
        self.requests = requests(p, ctx.seed_for("requests"))
        rng = random.Random(ctx.seed_for("check"))
        self.check_phase = rng.randrange(p["check_every"])
        self.kept: List[Tuple[int, int, torch.Tensor]] = []
        self.attempted = self.failed = 0
        self.warm()
        ctx.phase("warm")

    def warm(self):
        """Every request length of the mix once, the longest first, so the
        allocator holds blocks of every size before the window."""
        for n in sorted(set(self.ctx.params["frames"]), reverse=True):
            self.serve(0, n)
        self.ctx.spans.reset()

    def serve(self, offset: int, n: int) -> torch.Tensor:
        t = time.perf_counter()
        poses = self.infer(self.store[offset:offset + n]).cpu()
        self.ctx.spans.add("serve.request", time.perf_counter() - t)
        useful = n - self.window + 1
        self.ctx.spans.count("stream.useful_rows", useful)
        return poses

    def run(self, seconds: float) -> Dict[str, float]:
        lat, useful = [], 0
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            off, n = next(self.requests)
            t = time.perf_counter()
            poses = self.serve(off, n)
            lat.append(time.perf_counter() - t)
            i = self.attempted
            self.attempted += 1
            if poses.shape[0] != n - self.window + 1:
                self.failed += 1
                continue
            useful += poses.shape[0]
            if i % self.ctx.params["check_every"] == self.check_phase:
                self.kept.append((off, n, poses))
        wall = time.perf_counter() - start
        return {"serve_windows_per_s": useful / wall,
                "serve_p95_ms": checks.percentile(lat, 95) * 1e3,
                "requests": len(lat), "windows": useful}

    def traced(self, sub) -> Dict:
        self.ctx.spans.rows.clear()
        done = self.run(sub["seconds"])
        return {"batches": list(self.ctx.spans.rows),
                "windows": done["windows"]}

    def free(self):
        self.infer = None

    def check(self) -> Dict[str, float]:
        """Each kept request's poses against the reference's, in fp32."""
        checks.exact_fp32()
        p = ref.state(self.sd, self.ctx.device)
        got, want = [], []
        for off, n, poses in self.kept:
            win = self.store[off:off + n].unfold(0, self.window, 1)
            want.append(ref.serve(p, win, self.ctx.cfg).cpu())
            got.append(poses)
        return checks.pose_gaps(got, want)


def setup(ctx):
    return Stream(ctx)
