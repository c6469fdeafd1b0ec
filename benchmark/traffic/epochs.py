"""Training epochs on a device-resident split: the program's train step on
batches drawn by a seeded permutation of the split, epoch after epoch.

Parameters (``params`` of the cell file):

* ``windows``: the train split, ``[windows, *input]`` fp32 CSI (standard
  normal) and ``[windows, keypoints, dims]`` keypoints (uniform in
  [0, 1)), drawn from the seed on the device in two calls;
* ``batch``: the physical batch; each epoch is a permutation of the
  split drawn from the seed, cut into whole batches;
* ``switches``: the program's train-mode switches (for WiFlow the
  lowering of the TCN and the conv stack: ``fused`` or ``xla``, the
  stock torch ops);
* ``check_steps``: the steps the reference follows, twice: the first
  steps of set-up, from the seed, and as many after the measured window,
  from the state the window left, both through the same call and feed
  as the window;
* ``warm_steps``: further steps of set-up before the window.

The window counts the optimizer steps it completes: its clock stops at
the synchronize that ends it.  The comparison reads, for each of the two
stretches of ``check_steps``, the steps' losses, the gradient AdamW got
at the first step (from its first moment before and after it), the
parameters after the last, and the running mean of the BatchNorm that
reads the input.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

import torch

from benchmark import checks
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train


class Stretch:
    """What a few consecutive steps of the program leave for the
    comparison: the batches, the losses, the first step's gradient, and
    the parameters and the input BatchNorm's running mean before and
    after."""

    def __init__(self, idx: List[torch.Tensor], losses: List[float],
                 grads, before, after, mean_before, mean_after,
                 snapshot: Optional[Dict]):
        self.idx, self.losses, self.grads = idx, losses, grads
        self.before, self.after = before, after
        self.mean_before, self.mean_after = mean_before, mean_after
        self.snapshot = snapshot


class Epochs:
    def __init__(self, ctx):
        self.ctx, p, cfg = ctx, ctx.params, ctx.cfg
        dev = ctx.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(ctx.seed_for("split"))
        n = p["windows"]
        self.x = torch.randn((n, *ref_model.input_shape(cfg)), generator=gen,
                             device=dev)
        self.y = torch.rand((n, cfg["num_keypoints"], cfg["keypoint_dims"]),
                            generator=gen, device=dev)
        ctx.phase("store")
        self.sd = ctx.weights()
        ctx.phase("weights")
        self.drop_seed = ctx.seed_for("dropout")
        self.state = ctx.program.trainer(self.sd, cfg, p["switches"],
                                         self.drop_seed, dev)
        ctx.phase("program")
        self.perm_gen = torch.Generator(device=dev)
        self.perm_gen.manual_seed(ctx.seed_for("epochs"))
        self.feed = self.batches()
        self.losses: List[torch.Tensor] = []
        self.attempted = self.failed = 0
        self.mean_key = ref_model.input_running_mean(cfg)
        self.start = self.follow(None)
        ctx.phase("check_steps")
        for _ in range(p["warm_steps"]):
            self.step(next(self.feed))
        self.losses = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ctx.phase("warm")
        ctx.spans.reset()
        self.late: Optional[Stretch] = None

    def batches(self) -> Iterator[torch.Tensor]:
        b, n = self.ctx.params["batch"], self.ctx.params["windows"]
        while True:
            perm = torch.randperm(n, generator=self.perm_gen,
                                  device=self.ctx.device)
            for i in range(n // b):
                yield perm[i * b:(i + 1) * b]

    def step(self, idx: torch.Tensor) -> torch.Tensor:
        t = time.perf_counter()
        loss = self.ctx.program.step(self.state, self.x[idx], self.y[idx])
        self.ctx.spans.add("train.step", time.perf_counter() - t)
        return loss

    def follow(self, snapshot: Optional[Dict]) -> Stretch:
        """``check_steps`` steps of the program from where it stands
        (``snapshot``: a copy of that state, None at the seed)."""
        prog, beta1 = self.ctx.program, self.ctx.cfg["optimizer"]["betas"][0]

        def moments():
            return {k: v.detach().clone()
                    for k, v in prog.first_moments(self.state).items()}

        def params():
            return {k: v.detach().clone()
                    for k, v in prog.parameters(self.state).items()}

        def mean():
            return (prog.buffers(self.state)[self.mean_key].detach().float()
                    .clone())

        before, mean_before = params(), mean()
        m0 = moments() if snapshot is not None else None
        idx, losses, grads = [], [], {}
        for i in range(self.ctx.params["check_steps"]):
            idx.append(next(self.feed))
            losses.append(self.step(idx[-1]))
            if i == 0:
                m1 = moments()
                grads = {k: (v if m0 is None else v - beta1 * m0[k])
                         / (1 - beta1) for k, v in m1.items()}
        self.losses.extend(losses)
        return Stretch(idx, [float(v) for v in losses], grads, before,
                       params(), mean_before, mean(), snapshot)

    def run(self, seconds: float) -> Dict[str, float]:
        steps = 0
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            self.losses.append(self.step(next(self.feed)))
            steps += 1
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        wall = time.perf_counter() - start
        self.attempted += steps
        return {"train_windows_per_s": steps * self.ctx.params["batch"] / wall,
                "steps": steps}

    def traced(self, sub) -> Dict:
        for _ in range(sub["steps"]):
            self.losses.append(self.step(next(self.feed)))
        self.attempted += sub["steps"]
        b = self.ctx.params["batch"]
        return {"steps": sub["steps"], "batch": b, "windows": sub["steps"] * b}

    def free(self):
        """The steps after the window, then the program's state goes."""
        self.late = self.follow(self.ctx.program.snapshot(self.state))
        losses = torch.stack(self.losses) if self.losses else None
        self.failed = 0 if losses is None else int(
            (~torch.isfinite(losses)).sum())
        self.state = None

    def check(self):
        """Both stretches against the reference's steps, in fp32: from the
        same weights, batches and dropout draws at the seed, and from a
        copy of the program's state after the window.  Each compared
        number is the larger of the two stretches'."""
        checks.exact_fp32()
        found, info = {}, {}
        for name, s in (("start", self.start), ("late", self.late)):
            rec = ref_train.train_steps(
                self.sd, self.ctx.cfg,
                [(self.x[i], self.y[i]) for i in s.idx], self.drop_seed,
                snapshot=s.snapshot)
            k = self.mean_key
            comp, rep = checks.train_gaps(
                s.losses, rec.losses, s.grads, rec.grads,
                {n: s.after[n] - s.before[n] for n in s.after},
                {n: rec.after[n] - rec.before[n] for n in rec.after},
                s.mean_after - s.mean_before,
                rec.stats_after[k] - rec.stats_before[k])
            for n, v in comp.items():
                found[n] = max(found.get(n, v), v)
                info[f"{name}.{n}"] = v
            info.update({f"{name}.{n}": v for n, v in rep.items()})
        return found, info


def setup(ctx):
    return Epochs(ctx)
