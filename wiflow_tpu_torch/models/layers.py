"""Building blocks with torch ``state_dict`` names.

Counterpart of ``wiflow_tpu/models/layers.py``: BatchNorm in train and
eval mode, dropout and channel dropout, SiLU.

Dropout draws its keep bits from a ``torch.Generator`` that the model
holds (``WiFlowPoseModel.dropout_generator``, on the model's device) and
hands to every dropout module when it builds them; seeding that one
generator fixes every mask of a run.
"""

from __future__ import annotations

import torch
from torch import nn

from wiflow_tpu_torch.ops.norm import (
    MOMENTUM, batch_norm_eval, batch_norm_train, bn_vectors_from_sums,
    dropout, dropout2d, keep_mask, running_update,
)


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


class TorchBatchNorm(nn.Module):
    """BatchNorm over the channel axis of a channel-last activation.

    Holds exactly the parameters and buffers of torch's ``BatchNorm1d`` /
    ``BatchNorm2d`` (``weight``, ``bias``, ``running_mean``,
    ``running_var``, ``num_batches_tracked``), so reference checkpoints
    load by name.  In train mode it normalizes with the batch statistics
    and updates the running ones in place, as torch does.
    """

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    @torch.no_grad()
    def track(self, mean: torch.Tensor, var: torch.Tensor,
              count: int) -> None:
        """Move the running statistics toward a batch's ``mean`` and biased
        ``var`` over ``count`` elements per channel."""
        new_mean, new_var = running_update(self.running_mean,
                                           self.running_var, mean, var, count)
        self._store(new_mean, new_var)

    @torch.no_grad()
    def _store(self, new_mean: torch.Tensor, new_var: torch.Tensor) -> None:
        self.running_mean.copy_(new_mean)
        self.running_var.copy_(new_var)
        self.num_batches_tracked.add_(1)

    def from_sums(self, sums: torch.Tensor, count: int):
        """Train-mode BN for a fused stage: from the per-channel sum and
        sum of squares ``sums [2, C]`` of ``count`` elements, move the
        running statistics and return the fp32 apply vectors ``(m, a, b)``
        of ``y = (x - m) * a + b``."""
        m, a, b, var = bn_vectors_from_sums(sums, count, self.weight,
                                            self.bias)
        with torch.no_grad():
            # running <- running + 0.1 * (batch - running), in place
            self.running_mean.lerp_(m, MOMENTUM)
            self.running_var.lerp_(var * (count / max(count - 1, 1)),
                                   MOMENTUM)
            self.num_batches_tracked.add_(1)
        return m, a, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, new_mean, new_var = batch_norm_train(
                x, self.weight, self.bias, self.running_mean,
                self.running_var)
            self._store(new_mean, new_var)
            return y
        return batch_norm_eval(x, self.running_mean, self.running_var,
                               self.weight, self.bias)


class TorchDropout(nn.Module):
    """Elementwise dropout (torch ``nn.Dropout``); identity in eval mode."""

    def __init__(self, rate: float, generator: torch.Generator | None):
        super().__init__()
        self.rate, self.generator = rate, generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.generator) if self.training else x

    def keep_mask(self, x: torch.Tensor):
        """The bool keep-mask ``forward(x)`` would draw, for a fused stage
        to apply: ``x``'s shape, or None at rate 0."""
        return keep_mask(x.shape, self.rate, x.device, self.generator)


class TorchDropout2d(TorchDropout):
    """Channel dropout (torch ``nn.Dropout2d``) on ``[B, H, W, C]``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout2d(x, self.rate, self.generator) if self.training else x

    def keep_mask(self, x: torch.Tensor):
        """One bit per (sample, channel) of ``x [B, H, W, C]``, as
        ``[B, 1, 1, C]``, or None at rate 0."""
        return keep_mask((x.shape[0], 1, 1, x.shape[-1]), self.rate,
                         x.device, self.generator)
