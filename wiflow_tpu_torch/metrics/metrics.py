"""PCK and MPJPE with the reference's semantics.

Counterpart of ``wiflow_tpu/metrics/metrics.py`` (ref
utils/metrics.py:3-46): the "torso" normalizer is the distance between
keypoints 2 and 12, clamped to at least 0.01; PCK averages over every
keypoint of every sample at once; keypoints are in metres, so MPJPE is.
``pck_correct_fractions``, ``pck_per_keypoint`` and ``mpjpe`` return
device tensors (no host sync); ``calculate_pck`` and ``calculate_mpjpe``
return host floats.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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


def calculate_pck(pred, target, thresholds: Sequence[float] = (0.2,),
                  use_torso_norm: bool = True) -> Dict[float, float]:
    """``{threshold: pck}`` as host floats, like the reference."""
    fr = pck_correct_fractions(torch.as_tensor(pred), torch.as_tensor(target),
                               thresholds, use_torso_norm)
    return {t: float(v) for t, v in zip(thresholds, fr.tolist())}


def pck_per_keypoint(pred: torch.Tensor, target: torch.Tensor, thr: float,
                     scale_a: int, scale_b: int,
                     clamp: Optional[float] = None) -> torch.Tensor:
    """Per-keypoint PCK in percent, ``[K + 1]``: each keypoint's, then the
    overall one (the reference's ``compute_pck_pckh`` family, ref
    baseline/WPformer/evaluation.py:6-83).  The normalizer is the distance
    between target keypoints ``scale_a`` and ``scale_b``, clamped below at
    ``clamp`` where given.  Inputs are ``[B, K, D]``."""
    pred = _as_keypoints(pred).float()
    target = _as_keypoints(target).float()
    scale = torch.sqrt(((target[:, scale_a] - target[:, scale_b]) ** 2)
                       .sum(-1))
    if clamp is not None:
        scale = scale.clamp(min=clamp)
    dist = torch.sqrt(((pred - target) ** 2).sum(-1)) / scale[:, None]
    correct = (dist <= thr).float()                       # [B, K]
    return torch.cat([100.0 * correct.mean(0), 100.0 * correct.mean()[None]])


def mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error."""
    pred = _as_keypoints(pred).float()
    target = _as_keypoints(target).float()
    return torch.sqrt(((pred - target) ** 2).sum(-1)).mean()


def calculate_mpjpe(pred, target) -> float:
    return float(mpjpe(torch.as_tensor(pred), torch.as_tensor(target)))
