"""Building blocks with torch ``state_dict`` names.

Counterpart of ``wiflow_tpu/models/layers.py``, eval mode only: the
training slice adds train-mode BatchNorm (batch statistics, running
update) and dropout.
"""

from __future__ import annotations

import torch
from torch import nn

from wiflow_tpu_torch.ops.norm import batch_norm_eval


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


class TorchBatchNorm(nn.Module):
    """BatchNorm over the channel axis of a channel-last activation.

    Holds exactly the parameters and buffers of torch's ``BatchNorm1d`` /
    ``BatchNorm2d`` (``weight``, ``bias``, ``running_mean``,
    ``running_var``, ``num_batches_tracked``), so reference checkpoints
    load by name.  Only eval mode is implemented.
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet; call .eval()")
        return batch_norm_eval(x, self.running_mean, self.running_var,
                               self.weight, self.bias)
