"""Evaluation of whole MM-Fi subject sessions: one client in a closed
loop, each request ``k`` consecutive action sequences of one subject,
served by the configuration's forward in chunks and copied back to the
host.

Parameters (``params`` of the cell file):

* ``subjects``, ``actions``, ``frames``: the frame store, subjects x
  actions x frames frames of ``[antennas, subcarriers, window]`` fp32,
  standard normal, drawn from the seed on the device in one call;
* ``max_sequences``: ``k`` runs over 1..max; every seed serves each ``k``
  once a cycle, in its own order, each for a subject and a first action
  drawn from the seed;
* ``options``: the served forward's (:func:`benchmark.program.server`);
* ``chunk``: the most frames a call of the served forward takes; a
  request's last chunk is what is left, so every remainder of ``k``
  frames over ``chunk`` is a shape of its own, warmed up in set-up;
* ``check_every``: one request in so many is kept and compared with the
  reference after the window.

One frame is one window of the metrics.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Iterator, List, Tuple

import torch

from benchmark import checks
from benchmark.reference import model as ref


def requests(p, seed: int) -> Iterator[Tuple[int, int]]:
    """(first frame, frames) of each request, cycle after cycle."""
    rng = random.Random(seed)
    per_subject = p["actions"] * p["frames"]
    while True:
        ks = list(range(1, p["max_sequences"] + 1))
        rng.shuffle(ks)
        for k in ks:
            s = rng.randrange(p["subjects"])
            a = rng.randrange(p["actions"] - k + 1)
            yield s * per_subject + a * p["frames"], k * p["frames"]


class Sessions:
    def __init__(self, ctx):
        self.ctx, p, cfg = ctx, ctx.params, ctx.cfg
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed_for("store"))
        n = p["subjects"] * p["actions"] * p["frames"]
        self.store = torch.randn((n, *ref.input_shape(cfg)), generator=gen,
                                 device=ctx.device)
        ctx.phase("store")
        self.sd = ctx.weights()
        ctx.phase("weights")
        self.forward = ctx.program.server(self.sd, cfg, p.get("options", {}),
                                          ctx.spans, ctx.device)
        ctx.phase("program")
        self.requests = requests(p, ctx.seed_for("requests"))
        rng = random.Random(ctx.seed_for("check"))
        self.check_phase = rng.randrange(p["check_every"])
        self.kept: List[Tuple[int, int, torch.Tensor]] = []
        self.attempted = self.failed = 0
        self.warm()
        ctx.phase("warm")

    def warm(self):
        """Every chunk shape a request can make, the largest first."""
        p = self.ctx.params
        for k in range(p["max_sequences"], 0, -1):
            self.serve(0, k * p["frames"])
        self.ctx.spans.reset()

    def serve(self, first: int, n: int) -> torch.Tensor:
        c = self.ctx.params["chunk"]
        frames = self.store[first:first + n]
        out = [self.forward(frames[i:i + c]) for i in range(0, n, c)]
        return torch.cat(out).cpu()

    def run(self, seconds: float) -> Dict[str, float]:
        lat, useful = [], 0
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            first, n = next(self.requests)
            t = time.perf_counter()
            poses = self.serve(first, n)
            lat.append(time.perf_counter() - t)
            i = self.attempted
            self.attempted += 1
            if poses.shape[0] != n:
                self.failed += 1
                continue
            useful += n
            if i % self.ctx.params["check_every"] == self.check_phase:
                self.kept.append((first, n, poses))
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
        self.forward = None

    def check(self) -> Dict[str, float]:
        """Each kept request's poses against the reference's, in fp32."""
        checks.exact_fp32()
        p = ref.state(self.sd, self.ctx.device)
        want = [ref.serve(p, self.store[f:f + n], self.ctx.cfg).cpu()
                for f, n, _ in self.kept]
        return checks.pose_gaps([poses for _, _, poses in self.kept], want)


def setup(ctx):
    return Sessions(ctx)
