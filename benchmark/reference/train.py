"""Plain PyTorch reference of the train step.

The step of the WiFlow repository's ``train.py``: the configuration's
train-mode forward (batch statistics, dropout) and loss (its reference
module's ``loss``; for WiFlow the pose loss of ``losses/pose_loss.py``:
smooth L1 on positions with beta 0.1, on the bone lengths with beta
0.05, weight 0.2), autograd's backward, a clip of the global gradient
norm to the configuration's (scaled only where the norm reaches it), and
AdamW as the configuration's ``optimizer`` states it (WiFlow: lr 1e-4,
betas 0.9 / 0.999, eps 1e-8, weight decay 5e-5 on every parameter), all
in float32.  Each BatchNorm's running statistics move toward the batch's
as torch's do (momentum 0.1, the unbiased variance).

A trainer starts from a ``state_dict`` (the first steps of a run) or
from a :class:`Snapshot` of a train state taken later (the steps after
the measured window), which carries the optimizer's moments and the
dropout generator's state as well.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from benchmark.reference.model import (
    MOMENTUM, Run, dropout_rates, family, forward, fp32, parameter_names,
)

Tensor = torch.Tensor


def smooth_l1(d: Tensor, beta: float) -> Tensor:
    a = d.abs()
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def pose_loss(pred: Tensor, target: Tensor, loss: Mapping) -> Tensor:
    conn = loss["connections"]
    s = torch.tensor([a for a, _ in conn], device=pred.device)
    e = torch.tensor([b for _, b in conn], device=pred.device)

    def bones(k):
        v = k[:, e] - k[:, s]
        return torch.sqrt((v * v).sum(-1) + 1e-8)

    pos = smooth_l1(pred - target, loss["position_beta"]).mean()
    bone = smooth_l1(bones(pred) - bones(target), loss["bone_beta"]).mean()
    return loss["position_weight"] * pos + loss["bone_weight"] * bone


class Trainer:
    """The reference's train state: float32 parameters, their AdamW, and
    the dropout generator on ``device``: from the weights ``sd`` with a
    generator seeded with ``drop_seed``, or from ``snapshot`` (a dict:
    ``params``, ``buffers`` by name, AdamW's ``exp_avg``, ``exp_avg_sq``
    by parameter name and its ``step``, and the dropout ``generator``'s
    state), a train state taken later in a run.  ``q``: the rounding of
    every op (:func:`benchmark.reference.model.fp8` for the control);
    ``rows``: each step's loss and statistics over the first ``rows``
    samples only (a planted fault: half of the batch left out)."""

    def __init__(self, sd: Optional[Mapping[str, Tensor]], cfg: Mapping,
                 drop_seed: int, device, *, q: Callable = fp32,
                 rows: Optional[int] = None,
                 snapshot: Optional[Mapping] = None):
        self.cfg, self.q, self.rows = cfg, q, rows
        names = parameter_names(cfg)
        if snapshot is not None:
            sd = {**snapshot["buffers"], **snapshot["params"]}
        self.buffers = {k: v.to(device, torch.float32) for k, v in sd.items()
                        if k not in names
                        and not k.endswith("num_batches_tracked")}
        self.params = {k: sd[k].to(device, torch.float32).clone()
                       .requires_grad_(True) for k in names}
        o = cfg["optimizer"]
        self.clip = o["grad_clip_norm"]
        self.opt = torch.optim.AdamW(
            list(self.params.values()), lr=o["lr"], betas=tuple(o["betas"]),
            eps=o["eps"], weight_decay=o["weight_decay"], foreach=False)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(drop_seed)
        if snapshot is not None:
            for k, p in self.params.items():
                self.opt.state[p] = {
                    "step": torch.tensor(float(snapshot["step"])),
                    "exp_avg": snapshot["exp_avg"][k].to(device).clone(),
                    "exp_avg_sq": snapshot["exp_avg_sq"][k].to(device)
                    .clone()}
            self.gen.set_state(snapshot["generator"])
        self.grads: Dict[str, Tensor] = {}    # the latest step's, clipped

    def snapshot(self) -> Dict:
        """This state as :class:`Trainer` takes it back."""
        first = next(iter(self.params.values()))
        st = self.opt.state.get(first, {})
        return {"params": {k: v.detach().clone()
                           for k, v in self.params.items()},
                "buffers": {k: v.clone() for k, v in self.buffers.items()},
                "exp_avg": {k: self.opt.state[p]["exp_avg"].clone()
                            for k, p in self.params.items()} if st else
                {k: torch.zeros_like(p) for k, p in self.params.items()},
                "exp_avg_sq": {k: self.opt.state[p]["exp_avg_sq"].clone()
                               for k, p in self.params.items()} if st else
                {k: torch.zeros_like(p) for k, p in self.params.items()},
                "step": int(st["step"]) if st else 0,
                "generator": self.gen.get_state()}

    def step(self, x: Tensor, y: Tensor) -> Tensor:
        if self.rows is not None:
            x, y = x[:self.rows], y[:self.rows]
        stats: Dict = {}
        run = Run({**self.buffers, **self.params}, self.q, train=True,
                  gen=self.gen, rates=dropout_rates(self.cfg), stats=stats)
        loss = family(self.cfg).loss(forward(run, x, self.cfg), y.float(),
                                     self.cfg)
        for prefix, (mean, var, n) in stats.items():
            for key, batch in (("running_mean", mean),
                               ("running_var", var * (n / max(n - 1, 1)))):
                old = self.buffers[f"{prefix}.{key}"]
                self.buffers[f"{prefix}.{key}"] = (old + MOMENTUM
                                                   * (batch - old))
        params = list(self.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if norm >= self.clip:
            grads = [g * (self.clip / norm) for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        self.opt.step()
        self.grads = dict(zip(self.params, grads))
        return loss.detach()

    def first_moments(self) -> Dict[str, Tensor]:
        return {k: self.opt.state[p]["exp_avg"]
                for k, p in self.params.items()}


class StepRecord:
    """What the comparison reads of a few steps: each step's loss, the
    first step's clipped gradient of every parameter, the parameters and
    the running statistics before the first step and after the last."""

    def __init__(self):
        self.losses: List[float] = []
        self.grads: Dict[str, Tensor] = {}
        self.before: Dict[str, Tensor] = {}
        self.after: Dict[str, Tensor] = {}
        self.stats_before: Dict[str, Tensor] = {}
        self.stats_after: Dict[str, Tensor] = {}


def train_steps(sd: Optional[Mapping[str, Tensor]], cfg: Mapping,
                batches: Sequence, drop_seed: int,
                snapshot: Optional[Mapping] = None) -> StepRecord:
    """The reference's float32 steps on ``batches`` ``[(x, y), ...]`` from
    the weights ``sd``, the dropout masks drawn from a generator seeded
    with ``drop_seed`` on ``x``'s device; or from ``snapshot``
    (:class:`Trainer`)."""
    t = Trainer(sd, cfg, drop_seed, batches[0][0].device, snapshot=snapshot)
    rec = StepRecord()
    rec.before = {k: v.detach().clone() for k, v in t.params.items()}
    rec.stats_before = dict(t.buffers)
    for i, (x, y) in enumerate(batches):
        rec.losses.append(t.step(x, y).item())
        if i == 0:
            rec.grads = {k: g.detach().clone() for k, g in t.grads.items()}
    rec.after = {k: v.detach().clone() for k, v in t.params.items()}
    rec.stats_after = dict(t.buffers)
    return rec
