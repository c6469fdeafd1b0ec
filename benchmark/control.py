"""Stand-ins for the program: the reference put in its place, computed in
the nearest precision below the configuration's (the control), or with a
fault planted in it.  Each has the interface of :mod:`benchmark.program`,
so a run drives it as it drives the program, and its comparison with the
float32 reference has to come out as not correct.

* ``control``: the reference in float8 e4m3 (the configuration computes
  in bfloat16);
* ``half``: serving: each call computes the first half of its rows and
  gives the rest the mean of those; training: the step's loss and
  statistics over the first half of the batch;
* ``altered``: serving: each call's first answer is garbage (1e4), as
  from memory the kernel never wrote;
* ``unchanged``: training: the step leaves the state as it was;
* ``bf16``: the reference rounded to bfloat16 after every op, the
  configuration's precision: not a control but a witness of how far
  rounding alone moves each number.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

KINDS = ("control", "half", "altered", "unchanged", "bf16")


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class StandIn:
    def __init__(self, kind: str):
        if kind not in KINDS:
            raise ValueError(f"stand-in {kind!r}: one of {KINDS}")
        self.kind = kind
        self.q = {"control": ref.fp8, "bf16": bf16}.get(kind, ref.fp32)

    def build_kernels(self, names):
        return {}

    def launches(self) -> Dict[str, int]:
        return {}

    def _forward(self, sd, cfg, device):
        p = ref.state(sd, device)

        def forward(x: torch.Tensor) -> torch.Tensor:
            n = x.shape[0]
            if self.kind == "half":
                y = ref.serve(p, x[:(n + 1) // 2], cfg)
                return torch.cat([y, y.mean(0, keepdim=True)
                                  .expand(n - y.shape[0], *y.shape[1:])])
            y = ref.serve(p, x, cfg, q=self.q)
            if self.kind == "altered":
                y[0] = 1e4
            return y

        return forward

    def stream_server(self, sd, cfg: Mapping, batch: int, options, spans,
                      device):
        forward = self._forward(sd, cfg, device)

        def infer(stream: torch.Tensor) -> torch.Tensor:
            win = stream.unfold(0, cfg["window_size"], 1)
            return torch.cat([forward(win[i:i + batch])
                              for i in range(0, win.shape[0], batch)])

        return infer

    def server(self, sd, cfg: Mapping, options, spans, device):
        return self._forward(sd, cfg, device)

    def trainer(self, sd, cfg, switches, drop_seed: int, device):
        return ref_train.Trainer(
            sd, cfg, drop_seed, device, q=self.q,
            rows=None if self.kind != "half" else -1)

    def step(self, state, xb, yb):
        if self.kind == "unchanged":
            return torch.zeros((), device=xb.device)
        if state.rows == -1:
            state.rows = xb.shape[0] // 2
        return state.step(xb, yb)

    def parameters(self, state):
        return state.params

    def buffers(self, state):
        return state.buffers

    def first_moments(self, state):
        if self.kind == "unchanged":
            return {k: torch.zeros_like(p) for k, p in state.params.items()}
        return state.first_moments()

    def snapshot(self, state):
        return state.snapshot()
