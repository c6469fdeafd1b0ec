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
  * eval uses the running BN statistics; it reports PCK@{0.1..0.5};
  * the hooks of ``make_step_fns``: ``connections`` (the skeleton of the
    bone loss), ``pck_fn``, ``mpe_fn``, ``loss_fn`` and ``to_keypoints``,
    with the same defaults; augmentation (``data/augment.py``) of the
    whole batch before the step when the caller passes a generator.

Spans (``utils/trace.py``): ``train.step`` around a call of
:func:`train_step`, and inside it, for each micro-batch,
``train.forward``, ``train.loss`` (the loss and the batch's metrics) and
``train.backward``, then ``train.optimizer`` (the division of summed
micro-batch gradients, their average over ranks, the zero-fill, the clip
and the optimizer step); counter ``train.steps``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from wiflow_tpu_torch.core.config import (
    LossConfig, ModelConfig, OptimConfig, resolve_device,
)
from wiflow_tpu_torch.data.augment import augment_batch
from wiflow_tpu_torch.losses.pose_loss import pose_loss
from wiflow_tpu_torch.metrics.metrics import mpjpe, pck_correct_fractions
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.parallel.mesh import (
    average_gradients, data_parallel, gather_batches, local_rows,
    mean_over_ranks,
)
from wiflow_tpu_torch.train.optim import apply_gradients, make_optimizer
from wiflow_tpu_torch.utils import trace

TEST_THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5)
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN running statistics), its optimizer,
    the clip applied before each optimizer step, and the parameters whose
    gradients are zeroed before it (``frozen_params``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    grad_clip_norm: Optional[float] = 1.0
    frozen: Tuple[nn.Parameter, ...] = ()


def create_train_state(cfg: ModelConfig = ModelConfig(),
                       optim: OptimConfig = OptimConfig(), seed: int = 42,
                       device=None, *, model: Optional[nn.Module] = None,
                       frozen_params: Sequence[str] = ()) -> TrainState:
    """A model in train mode and its optimizer.

    Without ``model``: a fresh ``WiFlowPoseModel(cfg)`` on ``device``
    (CUDA unless ``device="cpu"``), its weights and dropout masks drawn
    from ``seed``.  ``model``: the caller's module, on its own device.
    ``frozen_params`` names top-level submodules whose gradients are set
    to zero before the clip (the JAX package's ``frozen_subtrees``)."""
    if model is None:
        dev = resolve_device(device)
        model = WiFlowPoseModel(cfg, device=dev,
                                generator=torch.Generator().manual_seed(seed))
        model.dropout_generator.manual_seed(seed)
    model.train()
    tops = {name for name, _ in model.named_children()}
    unknown = set(frozen_params) - tops
    if unknown:
        raise ValueError(f"frozen_params {sorted(unknown)} are not top-level "
                         f"modules of the model ({sorted(tops)})")
    frozen = tuple(p for n, p in model.named_parameters()
                   if n.split(".")[0] in frozen_params)
    return TrainState(model, make_optimizer(optim, model.parameters()),
                      optim.grad_clip_norm, frozen)


class Hooks(NamedTuple):
    """What a step computes besides the model: ``loss_fn(out, y) ->
    (total, {'position', 'bone'})``, ``to_keypoints(out, y) -> (pred,
    target)`` keypoints for the metrics, ``pck_fn(pred, target,
    thresholds) -> [len(thresholds)]`` and ``mpe_fn(pred, target)``."""

    loss_fn: Callable
    pck_fn: Callable
    mpe_fn: Callable
    to_keypoints: Callable


def make_hooks(loss_cfg: LossConfig = LossConfig(), connections=None,
               pck_fn=None, mpe_fn=None, loss_fn=None,
               to_keypoints=None) -> Hooks:
    """The hooks with the JAX package's defaults: the pose loss of
    ``loss_cfg`` over ``connections`` (the 15-keypoint skeleton when None),
    torso-normalised PCK, MPJPE, outputs taken as keypoints."""
    if loss_fn is None:
        kw = {} if connections is None else {"connections": connections}

        def loss_fn(out, yb):
            return pose_loss(out, yb, loss_cfg, **kw)
    return Hooks(loss_fn, pck_fn or pck_correct_fractions, mpe_fn or mpjpe,
                 to_keypoints or (lambda out, yb: (out, yb)))


def make_batch_indices(num_samples: int, batch_size: int,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[num_batches, batch_size]`` index table, drop_last semantics."""
    nb = num_samples // batch_size
    idx = perm if perm is not None else torch.arange(num_samples)
    return idx[: nb * batch_size].reshape(nb, batch_size)


def _batch_metrics(hooks: Hooks, loss: torch.Tensor, parts: Metrics,
                   out: torch.Tensor, yb: torch.Tensor) -> Metrics:
    kp_p, kp_t = hooks.to_keypoints(out.detach(), yb)
    pck = hooks.pck_fn(kp_p, kp_t, (0.2, 0.5))
    return {"loss": loss.detach(), "position": parts["position"].detach(),
            "bone": parts["bone"].detach(), "mpe": hooks.mpe_fn(kp_p, kp_t),
            "pck": pck[0], "pck50": pck[1]}


def _mean(ms) -> Metrics:
    return {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}


def train_step(state: TrainState, xb: torch.Tensor, yb: torch.Tensor,
               loss_cfg: LossConfig = LossConfig(),
               grad_accum_steps: int = 1, *, hooks: Optional[Hooks] = None,
               augment: Optional[torch.Generator] = None) -> Metrics:
    """One optimizer step on the batch ``xb``, ``yb`` (``[B, 540, 20]``,
    ``[B, 15, 2]`` for ``WiFlowPoseModel``; ``[B, 3, 114, 10]``, ``[B, 17,
    3]`` for ``WiFlowMMFiModel``): augmentation drawn from ``augment``
    where given, forward in train
    mode, loss (the pose loss of ``loss_cfg`` unless ``hooks`` says
    otherwise), backward, clip, optimizer.  Updates ``state`` in place;
    returns the step's metrics (this rank's) as device tensors.  In a
    process group the step is data-parallel (``parallel/mesh.py``):
    ``xb``, ``yb`` are the global batch."""
    with trace.span("train.step"):
        hooks = hooks or make_hooks(loss_cfg)
        if augment is not None:
            xb = augment_batch(xb, augment)
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        a = max(1, grad_accum_steps)
        mb = xb.shape[0] // a
        ms = []
        with data_parallel():
            for i in range(a):
                x_i = local_rows(xb[i * mb:(i + 1) * mb])
                y_i = local_rows(yb[i * mb:(i + 1) * mb])
                with trace.span("train.forward"):
                    out = model(x_i)
                with trace.span("train.loss"):
                    loss, parts = hooks.loss_fn(out, y_i)
                    ms.append(_batch_metrics(hooks, loss, parts, out, y_i))
                with trace.span("train.backward"):
                    loss.backward()
        metrics = _mean(ms)
        with trace.span("train.optimizer"):
            if a > 1:
                torch._foreach_div_([p.grad for p in model.parameters()
                                     if p.grad is not None], a)
            average_gradients(list(model.parameters()))
            metrics["grad_norm"] = apply_gradients(opt, state.grad_clip_norm,
                                                   state.frozen)
        trace.count("train.steps")
    return metrics


@torch.no_grad()
def eval_step(model: nn.Module, xb: torch.Tensor, yb: torch.Tensor,
              loss_cfg: LossConfig = LossConfig(), *,
              hooks: Optional[Hooks] = None
              ) -> Tuple[Metrics, Tuple[torch.Tensor, torch.Tensor]]:
    """Eval-mode forward, loss, MPJPE and the PCK curve at
    ``TEST_THRESHOLDS``; returns the metrics and the (pred, target)
    keypoints, of this rank's rows of ``xb``, ``yb``."""
    hooks = hooks or make_hooks(loss_cfg)
    training = model.training
    model.eval()
    try:
        with data_parallel():
            xb, yb = local_rows(xb), local_rows(yb)
            out = model(xb)
    finally:
        model.train(training)
    total, parts = hooks.loss_fn(out, yb)
    kp_p, kp_t = hooks.to_keypoints(out, yb)
    curve = hooks.pck_fn(kp_p, kp_t, TEST_THRESHOLDS)
    m = {"loss": total, "position": parts["position"],
         "bone": parts["bone"], "mpe": hooks.mpe_fn(kp_p, kp_t),
         "pck": curve[1], "pck50": curve[4], "pck_curve": curve}
    return m, (kp_p, kp_t.to(kp_p.dtype))


def train_epoch(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                batch_idx: torch.Tensor, loss_cfg: LossConfig = LossConfig(),
                grad_accum_steps: int = 1, *, hooks: Optional[Hooks] = None,
                augment: Optional[torch.Generator] = None) -> Metrics:
    """One step per row of ``batch_idx`` (on ``x``'s device); the mean of
    the steps' metrics over the steps and the ranks."""
    return mean_over_ranks(_mean([train_step(state, x[idx], y[idx], loss_cfg,
                             grad_accum_steps, hooks=hooks, augment=augment)
                  for idx in batch_idx]))


def eval_epoch(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
               batch_idx: torch.Tensor, loss_cfg: LossConfig = LossConfig(),
               *, hooks: Optional[Hooks] = None
               ) -> Tuple[Metrics, Tuple[torch.Tensor, torch.Tensor]]:
    """Eval over the rows of ``batch_idx``: mean metrics (over the batches
    and the ranks), and the predictions and targets of every row,
    concatenated in the table's order."""
    ms, preds, targets = [], [], []
    for idx in batch_idx:
        m, (p, t) = eval_step(model, x[idx], y[idx], loss_cfg, hooks=hooks)
        ms.append(m)
        preds.append(p)
        targets.append(t)
    nb = len(batch_idx)
    return mean_over_ranks(_mean(ms)), (
        gather_batches(torch.cat(preds), nb),
        gather_batches(torch.cat(targets), nb))


def make_step_fns(loss_cfg: LossConfig = LossConfig(),
                  use_augmentation: bool = False, grad_accum_steps: int = 1,
                  connections=None, pck_fn=None, mpe_fn=None, loss_fn=None,
                  to_keypoints=None):
    """``(train_epoch, eval_epoch)`` with the hooks bound, as the JAX
    package's ``make_step_fns`` returns them:

      train_epoch(state, x, y, batch_idx, augment=None) -> metrics
      eval_epoch(model, x, y, batch_idx) -> (metrics, (pred, target))

    ``augment`` is the generator of the epoch's augmentation draws, used
    only when ``use_augmentation``."""
    hooks = make_hooks(loss_cfg, connections, pck_fn, mpe_fn, loss_fn,
                       to_keypoints)

    def train(state, x, y, batch_idx, augment=None):
        return train_epoch(state, x, y, batch_idx, loss_cfg,
                           grad_accum_steps, hooks=hooks,
                           augment=augment if use_augmentation else None)

    def evaluate(model, x, y, batch_idx):
        return eval_epoch(model, x, y, batch_idx, loss_cfg, hooks=hooks)

    return train, evaluate
