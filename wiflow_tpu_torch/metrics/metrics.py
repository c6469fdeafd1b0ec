"""PCK and MPJPE with the reference's semantics.

Counterpart of ``wiflow_tpu/metrics/metrics.py`` (ref
utils/metrics.py:3-46): the "torso" normalizer is the distance between
keypoints 2 and 12, clamped to at least 0.01; PCK averages over every
keypoint of every sample at once; keypoints are in metres, so MPJPE is.
Both return device tensors (no host sync).
"""

from __future__ import annotations

from typing import Sequence

import torch

from wiflow_tpu_torch.core.config import device_constant

TORSO_A, TORSO_B = 2, 12
SHOULDER_A, SHOULDER_B = 2, 5
NORM_CLAMP = 0.01


def _as_keypoints(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 2:
        return x.reshape(x.shape[0], -1, 2)
    return x


def pck_correct_fractions(pred: torch.Tensor, target: torch.Tensor,
                          thresholds: Sequence[float],
                          use_torso_norm: bool = True) -> torch.Tensor:
    """``[len(thresholds)]`` fractions of keypoints within each threshold
    times the sample's normalizer."""
    pred = _as_keypoints(pred).float()
    target = _as_keypoints(target).float()
    a, b = (TORSO_A, TORSO_B) if use_torso_norm else (SHOULDER_A, SHOULDER_B)
    norm = torch.sqrt(((target[:, a] - target[:, b]) ** 2).sum(-1))
    norm = norm.clamp(min=NORM_CLAMP)
    dist = torch.sqrt(((pred - target) ** 2).sum(-1)) / norm[:, None]
    thr = device_constant(thresholds, pred.device, torch.float32)
    return (dist[None] <= thr[:, None, None]).float().mean(dim=(1, 2))


def mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error."""
    pred = _as_keypoints(pred).float()
    target = _as_keypoints(target).float()
    return torch.sqrt(((pred - target) ** 2).sum(-1)).mean()
