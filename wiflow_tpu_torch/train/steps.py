"""Train and eval steps, and their epoch loops, on device-resident data.

Counterpart of ``wiflow_tpu/train/steps.py`` (ref train.py:181-260).  The
JAX package jits an epoch as one ``lax.scan``; here a step is eager torch
on the card, and an epoch is a Python loop over a ``[steps, batch]``
index table that gathers each batch on the device.  No step reads a value
back to the host: metrics stay device tensors until the epoch's end.

Semantics kept from the reference:
  * effective batch = physical batch x ``grad_accum_steps`` micro-batches;
    their gradients are summed and divided by the count, and each
    micro-batch's forward moves the BN running statistics;
  * global-norm clip (1.0), then AdamW (``train/optim.py``);
  * per-step train metrics (loss parts, MPJPE, PCK@0.2/0.5, the unclipped
    gradient norm) averaged over the epoch;
  * eval uses the running BN statistics; it reports PCK@{0.1..0.5}.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from wiflow_tpu_torch.core.config import (
    LossConfig, ModelConfig, OptimConfig, resolve_device,
)
from wiflow_tpu_torch.losses.pose_loss import pose_loss
from wiflow_tpu_torch.metrics.metrics import mpjpe, pck_correct_fractions
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.train.optim import apply_gradients, make_optimizer

TEST_THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5)
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN running statistics), its optimizer and
    the clip applied before each optimizer step."""

    model: WiFlowPoseModel
    optimizer: torch.optim.Optimizer
    grad_clip_norm: Optional[float] = 1.0


def create_train_state(cfg: ModelConfig = ModelConfig(),
                       optim: OptimConfig = OptimConfig(), seed: int = 42,
                       device=None) -> TrainState:
    """A fresh model in train mode on ``device`` (CUDA unless
    ``device="cpu"``), its weights and dropout masks drawn from ``seed``,
    and its optimizer."""
    dev = resolve_device(device)
    model = WiFlowPoseModel(cfg, device=dev,
                            generator=torch.Generator().manual_seed(seed))
    model.dropout_generator.manual_seed(seed)
    model.train()
    return TrainState(model, make_optimizer(optim, model.parameters()),
                      optim.grad_clip_norm)


def make_batch_indices(num_samples: int, batch_size: int,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[num_batches, batch_size]`` index table, drop_last semantics."""
    nb = num_samples // batch_size
    idx = perm if perm is not None else torch.arange(num_samples)
    return idx[: nb * batch_size].reshape(nb, batch_size)


def _batch_metrics(loss: torch.Tensor, parts: Metrics, out: torch.Tensor,
                   yb: torch.Tensor) -> Metrics:
    out = out.detach()
    pck = pck_correct_fractions(out, yb, (0.2, 0.5))
    return {"loss": loss.detach(), "position": parts["position"].detach(),
            "bone": parts["bone"].detach(), "mpe": mpjpe(out, yb),
            "pck": pck[0], "pck50": pck[1]}


def _mean(ms) -> Metrics:
    return {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}


def train_step(state: TrainState, xb: torch.Tensor, yb: torch.Tensor,
               loss_cfg: LossConfig = LossConfig(),
               grad_accum_steps: int = 1) -> Metrics:
    """One optimizer step on the batch ``xb [B, 540, 20]``, ``yb [B, 15,
    2]``: forward in train mode, pose loss, backward, clip, AdamW.  Updates
    ``state`` in place; returns the step's metrics as device tensors."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    a = max(1, grad_accum_steps)
    mb = xb.shape[0] // a
    ms = []
    for i in range(a):
        x_i, y_i = xb[i * mb:(i + 1) * mb], yb[i * mb:(i + 1) * mb]
        out = model(x_i)
        loss, parts = pose_loss(out, y_i, loss_cfg)
        loss.backward()
        ms.append(_batch_metrics(loss, parts, out, y_i))
    if a > 1:
        torch._foreach_div_([p.grad for p in model.parameters()
                             if p.grad is not None], a)
    metrics = _mean(ms)
    metrics["grad_norm"] = apply_gradients(opt, state.grad_clip_norm)
    return metrics


@torch.no_grad()
def eval_step(model: WiFlowPoseModel, xb: torch.Tensor, yb: torch.Tensor,
              loss_cfg: LossConfig = LossConfig()
              ) -> Tuple[Metrics, Tuple[torch.Tensor, torch.Tensor]]:
    """Eval-mode forward, loss, MPJPE and the PCK curve at
    ``TEST_THRESHOLDS``; returns the metrics and (pred, target)."""
    training = model.training
    model.eval()
    try:
        out = model(xb)
    finally:
        model.train(training)
    total, parts = pose_loss(out, yb, loss_cfg)
    curve = pck_correct_fractions(out, yb, TEST_THRESHOLDS)
    m = {"loss": total, "position": parts["position"],
         "bone": parts["bone"], "mpe": mpjpe(out, yb),
         "pck": curve[1], "pck50": curve[4], "pck_curve": curve}
    return m, (out, yb.to(out.dtype))


def train_epoch(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                batch_idx: torch.Tensor, loss_cfg: LossConfig = LossConfig(),
                grad_accum_steps: int = 1) -> Metrics:
    """One step per row of ``batch_idx`` (on ``x``'s device); the mean of
    the steps' metrics."""
    return _mean([train_step(state, x[idx], y[idx], loss_cfg,
                             grad_accum_steps) for idx in batch_idx])


def eval_epoch(model: WiFlowPoseModel, x: torch.Tensor, y: torch.Tensor,
               batch_idx: torch.Tensor, loss_cfg: LossConfig = LossConfig()
               ) -> Tuple[Metrics, Tuple[torch.Tensor, torch.Tensor]]:
    """Eval over the rows of ``batch_idx``: mean metrics, and the
    predictions and targets of every row, concatenated."""
    ms, preds, targets = [], [], []
    for idx in batch_idx:
        m, (p, t) = eval_step(model, x[idx], y[idx], loss_cfg)
        ms.append(m)
        preds.append(p)
        targets.append(t)
    return _mean(ms), (torch.cat(preds), torch.cat(targets))
