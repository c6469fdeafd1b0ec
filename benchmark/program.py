"""The system under test.  This module and the adapters in
``benchmark/programs/`` are the only ones of the benchmark that import
``wiflow_tpu_torch``.

The benchmark takes from the program its entry points (a served forward,
``make_stream_infer``, ``create_train_state`` / ``train_step``), the
launch counters of its CUDA kernels (``CudaKernel.launches``) and their
names, and its model's and optimizer's state, which the comparison
reads.  Everything else (inputs, weights, timing, work, the reference) is
the benchmark's own.

What differs between configurations sits in the adapter the
configuration file names under ``program``
(``benchmark/programs/<name>.py``): ``model_config(cfg, **switches)``,
``serve_forward(sd, cfg, device, **options)`` (``x -> poses`` on the
device, one call of the served forward) and ``train_model(cfg, device,
**switches)`` (the model in train mode).
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Dict, Mapping, NamedTuple

import torch

from wiflow_tpu_torch.core.config import LossConfig, OptimConfig
from wiflow_tpu_torch.eval.streaming import make_stream_infer
from wiflow_tpu_torch.ops.kernels import axial_attention, build
from wiflow_tpu_torch.ops.kernels import axial_attention_train as train_k
from wiflow_tpu_torch.ops.kernels import conv_stack, stage_fused, tcn_level
from wiflow_tpu_torch.train.steps import (
    Hooks, create_train_state, make_hooks, train_step,
)

# launch counters by the names the metric files use
KERNELS = {
    "tcn_level": tcn_level.KERNEL,
    "conv_stack": conv_stack.KERNEL,
    "axial_attention": axial_attention.KERNEL,
    "axial_attention_dual": axial_attention.KERNEL_DUAL,
    "axial_attention_v1": axial_attention.KERNEL_V1,
    "core_fwd": train_k.CORE_FORWARD,
    "core_bwd": train_k.CORE_BACKWARD,
    "sums_fwd": train_k.SUMS_FORWARD,
    "sums_bwd": train_k.SUMS_BACKWARD,
    "stage_fwd": stage_fused.STAGE_FORWARD,
    "stage_bwd": stage_fused.STAGE_BACKWARD,
    "join_fwd": stage_fused.JOIN_FORWARD,
    "join_bwd": stage_fused.JOIN_BACKWARD,
}


def build_kernels(names) -> Dict[str, float]:
    """Build (nvcc, once a checkout) and load the libraries of the kernels
    named, all builds at once; seconds a library."""
    libs = sorted({KERNELS[n].name for n in names})
    secs = build.build(libs)
    for n in names:
        KERNELS[n].load()
    return secs


def launches() -> Dict[str, int]:
    return {n: k.launches for n, k in KERNELS.items()}


def adapter(cfg: Mapping):
    """The configuration's adapter, ``benchmark/programs/<program>.py``."""
    return importlib.import_module(f"benchmark.programs.{cfg['program']}")


def dataclass_from(cls, cfg: Mapping, **switches):
    """``cls`` (a frozen config dataclass of the program) from the keys of
    the configuration file that are its fields, lists as tuples."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in fields}
    return cls(**kw, **switches)


def server(sd: Mapping[str, torch.Tensor], cfg: Mapping,
           options: Mapping, spans, device: torch.device):
    """``forward(x) -> poses`` on ``device``: one call of the
    configuration's served forward with ``options``.  ``spans`` gets the
    host time and the rows of every call (:meth:`Spans.call`,
    ``serve.call``; no synchronize)."""
    fwd = adapter(cfg).serve_forward(sd, cfg, device, **options)

    def forward(x: torch.Tensor) -> torch.Tensor:
        t = time.perf_counter()
        out = fwd(x)
        spans.call("serve.call", x.shape[0], time.perf_counter() - t)
        return out

    return forward


def stream_server(sd: Mapping[str, torch.Tensor], cfg: Mapping, batch: int,
                  options: Mapping, spans, device: torch.device):
    """``infer(stream [T, S]) -> poses [T - window + 1, K, D]`` on
    ``device``: the stream layer over :func:`server`'s forward, which
    ``spans`` sees each batch of."""
    return make_stream_infer(server(sd, cfg, options, spans, device),
                             window=cfg["window_size"], batch=batch,
                             device=device)


class Training(NamedTuple):
    state: object            # the program's TrainState
    hooks: Hooks


def trainer(sd: Mapping[str, torch.Tensor], cfg: Mapping,
            switches: Mapping, drop_seed: int, device: torch.device):
    """The train step's state on ``device``: the model with ``sd`` loaded,
    in train mode with ``switches``, its dropout generator seeded with
    ``drop_seed``, AdamW and the loss as the configuration states them."""
    o, loss = cfg["optimizer"], dict(cfg["loss"])
    optim = OptimConfig(lr=o["lr"], weight_decay=o["weight_decay"],
                        betas=tuple(o["betas"]),
                        grad_clip_norm=o["grad_clip_norm"], kind=o["kind"])
    connections = tuple(tuple(c) for c in loss.pop("connections"))
    model = adapter(cfg).train_model(cfg, device, **switches)
    model.load_state_dict(sd)
    model.dropout_generator.manual_seed(drop_seed)
    hooks = make_hooks(LossConfig(**loss), connections=connections)
    return Training(create_train_state(optim=optim, model=model), hooks)


def step(t: Training, xb: torch.Tensor, yb: torch.Tensor):
    """One optimizer step; returns the step's loss as a device tensor."""
    return train_step(t.state, xb, yb, hooks=t.hooks)["loss"]


def parameters(t: Training) -> Dict[str, torch.Tensor]:
    return dict(t.state.model.named_parameters())


def buffers(t: Training) -> Dict[str, torch.Tensor]:
    """The model's buffers (the BatchNorms' running statistics), by name."""
    return dict(t.state.model.named_buffers())


def first_moments(t: Training) -> Dict[str, torch.Tensor]:
    """AdamW's first moment of every parameter, by name."""
    opt = t.state.optimizer
    return {n: opt.state[p]["exp_avg"]
            for n, p in t.state.model.named_parameters()}


def snapshot(t: Training) -> Dict:
    """A copy of the train state, as the reference's trainer takes it up:
    parameters and buffers by name, AdamW's moments and step count, the
    dropout generator's state."""
    opt, model = t.state.optimizer, t.state.model
    named = list(model.named_parameters())
    st = [opt.state[p] for _, p in named]
    return {"params": {n: p.detach().float().clone() for n, p in named},
            "buffers": {n: b.detach().clone()
                        for n, b in model.named_buffers()},
            "exp_avg": {n: s["exp_avg"].clone()
                        for (n, _), s in zip(named, st)},
            "exp_avg_sq": {n: s["exp_avg_sq"].clone()
                           for (n, _), s in zip(named, st)},
            "step": int(st[0]["step"]),
            "generator": model.dropout_generator.get_state()}
