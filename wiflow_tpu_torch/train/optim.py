"""Optimizer, gradient clipping and LR schedules with the JAX package's
semantics.

Counterpart of ``wiflow_tpu/train/optim.py``.  The trunk's recipe (ref
train.py:105-121, 234-236) is global-norm clipping at 1.0, then AdamW
(betas 0.9/0.999, eps 1e-8, weight decay 5e-5 on every parameter).  The
clip follows optax's ``clip_by_global_norm``: gradients are scaled by
``max_norm / norm`` only when ``norm >= max_norm`` (torch's
``clip_grad_norm_`` adds 1e-6 to the norm and scales whenever it exceeds
the limit).  torch's AdamW skips a parameter whose ``.grad`` is ``None``
while optax decays every parameter, so :func:`apply_gradients` gives such
parameters a zero gradient first.  Frozen parameters (the JAX package's
``frozen_subtrees``) get a zero gradient before the clip, as optax masks
their updates before it clips, so they add nothing to the clip's norm.

``ReduceLROnPlateau``, ``EarlyStopping`` and ``epoch_schedule_lr`` are
copies of the JAX package's host-side code: mode 'min' for the trunk's val
MPE, 'max' for the MM-Fi variant's val PCK, and ``state_dict`` /
``load_state_dict`` for the resume bundle.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch

from wiflow_tpu_torch.core.config import OptimConfig


def make_optimizer(cfg: OptimConfig,
                   params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.kind`` (the clip is applied by
    :func:`apply_gradients`): AdamW (the trunk), Adam with no weight decay
    (optax's ``adam``) or SGD with ``cfg.momentum`` and no weight decay
    (optax's ``sgd``: its trace starts at the first gradient, as torch's
    momentum buffer does)."""
    if cfg.kind == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=tuple(cfg.betas),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.kind == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas),
                                eps=1e-8)
    if cfg.kind == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum)
    raise ValueError(f"unknown optimizer kind {cfg.kind!r}")


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, a 0-dim fp32 tensor."""
    norms = torch._foreach_norm([g.float() for g in grads], 2.0)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where ``norm >=
    max_norm`` (optax's rule), without a host sync; returns the norm
    before clipping."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


def apply_gradients(optimizer: torch.optim.Optimizer,
                    grad_clip_norm: Optional[float],
                    frozen: Sequence[torch.nn.Parameter] = ()
                    ) -> torch.Tensor:
    """Zero-fill missing gradients and those of ``frozen``, clip (``None``
    or <= 0: no clipping) and take the optimizer step.  Returns the
    unclipped global norm, which leaves ``frozen`` out."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for p in frozen:
        p.grad.zero_()
    grads = [p.grad for p in params]
    if grad_clip_norm is not None and grad_clip_norm > 0:
        norm = clip_by_global_norm_(grads, grad_clip_norm)
    else:
        norm = global_norm(grads)
    optimizer.step()
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def epoch_schedule_lr(cfg: OptimConfig, epoch: int) -> float:
    """Epoch-indexed LR schedules of the baselines.

    'linear_decay': constant until ``decay_start``, then linear to 0 at
    ``decay_end`` (WPformer LambdaLR).  'multistep': lr * gamma ** (number
    of milestones passed) (WiSPPN MultiStepLR).
    """
    if cfg.schedule == "linear_decay":
        if epoch <= cfg.decay_start:
            return cfg.lr
        span = max(cfg.decay_end - cfg.decay_start, 1)
        return cfg.lr * max(0.0, 1.0 - (epoch - cfg.decay_start) / span)
    if cfg.schedule == "multistep":
        k = sum(1 for m in cfg.milestones if epoch >= m)
        return cfg.lr * cfg.gamma ** k
    return cfg.lr


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch ``ReduceLROnPlateau`` (threshold_mode 'rel') on host floats;
    ``mode`` 'min' (val MPE) or 'max' (val PCK)."""

    lr: float
    factor: float = 0.5
    patience: int = 3
    threshold: float = 1e-4
    cooldown: int = 1
    min_lr: float = 0.0
    eps: float = 1e-8
    mode: str = "min"

    best: Optional[float] = None
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def __post_init__(self):
        if self.best is None:
            self.best = float("inf") if self.mode == "min" else float("-inf")

    @classmethod
    def from_config(cls, cfg: OptimConfig,
                    mode: str = "min") -> "ReduceLROnPlateau":
        return cls(lr=cfg.lr, factor=cfg.plateau_factor,
                   patience=cfg.plateau_patience,
                   threshold=cfg.plateau_threshold,
                   cooldown=cfg.plateau_cooldown,
                   min_lr=cfg.lr * cfg.min_lr_ratio, mode=mode)

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Feed the epoch's val metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k, v in state.items():
            setattr(self, k, v)


@dataclasses.dataclass
class EarlyStopping:
    """Strict-improvement early stop: ``mode`` 'min' (val MPE, ref
    train.py:361-384) or 'max' (val PCK, the MM-Fi variant)."""

    patience: int = 5
    mode: str = "min"
    best: Optional[float] = None
    counter: int = 0
    best_epoch: int = -1

    def __post_init__(self):
        if self.best is None:
            self.best = float("inf") if self.mode == "min" else float("-inf")

    def update(self, metric: float, epoch: int) -> bool:
        """Returns True when this epoch is a new best."""
        improved = (metric < self.best if self.mode == "min"
                    else metric > self.best)
        if improved:
            self.best = metric
            self.best_epoch = epoch
            self.counter = 0
            return True
        self.counter += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience

    def state_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k, v in state.items():
            setattr(self, k, v)
