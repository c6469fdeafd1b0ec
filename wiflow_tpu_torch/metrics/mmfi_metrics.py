"""MM-Fi (Setting 3) metrics on tensors: root-relative PCK, root-aligned
MPJPE, and PA-MPJPE (Procrustes-aligned).

Counterpart of ``wiflow_tpu/metrics/mmfi_metrics.py``:

  * ref cross_dataset_test/WiFlow/wiflow.py:610-643 — keypoints are
    pelvis-aligned (index 0) before distances; the PCK scale is the
    *unaligned* distance between target keypoints 11 and 1, clamped at 1e-5;
  * ref cross_dataset_test/HPE-Li/utils/eval.py:79-188 — similarity
    transform (Procrustes) alignment for PA-MPJPE.

Every function returns a tensor on its inputs' device and reads nothing
back to the host; only :func:`root_relative_pck` does, into floats.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from wiflow_tpu_torch.core.config import device_constant

ROOT_IDX = 0          # pelvis
SCALE_A, SCALE_B = 11, 1
SCALE_CLAMP = 1e-5


def _root_relative(pose: torch.Tensor) -> torch.Tensor:
    pose = pose.float()
    return pose - pose[:, ROOT_IDX:ROOT_IDX + 1]


def root_relative_pck_fractions(pred: torch.Tensor, target: torch.Tensor,
                                thresholds: Sequence[float]) -> torch.Tensor:
    """``[len(thresholds)]`` fractions of correct keypoints."""
    target = target.float()
    scale = (target[:, SCALE_A] - target[:, SCALE_B]).square().sum(-1).sqrt()
    scale = scale.clamp(min=SCALE_CLAMP)
    dist = (_root_relative(pred) - _root_relative(target)).square().sum(
        -1).sqrt() / scale[:, None]
    thr = device_constant(list(thresholds), dist.device, torch.float32)
    return (dist[None] <= thr[:, None, None]).float().mean(dim=(1, 2))


def root_relative_pck(pred: torch.Tensor, target: torch.Tensor,
                      thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5)
                      ) -> Dict[float, float]:
    fr = root_relative_pck_fractions(pred, target, thresholds).tolist()
    return dict(zip(thresholds, fr))


def root_aligned_mpjpe(pred: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """Mean joint error after pelvis alignment (wiflow.py:635-643)."""
    return (_root_relative(pred) - _root_relative(target)).square().sum(
        -1).sqrt().mean()


def similarity_transform(pred: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Batched Procrustes: ``pred [B, K, D]`` under its optimal scale,
    rotation and translation onto ``target`` (ref HPE-Li
    utils/eval.py:79-135)."""
    pred, target = pred.float(), target.float()
    mu_t = target.mean(dim=1, keepdim=True)
    x = pred - pred.mean(dim=1, keepdim=True)
    y = target - mu_t
    var_x = (x * x).sum(dim=(1, 2))                        # [B]
    cov = torch.einsum("bkd,bke->bde", y, x)               # [B, D, D]
    u, s, vt = torch.linalg.svd(cov)
    # reflection fix: det(U V^T) must be +1
    d = torch.ones_like(s)
    d[:, -1] = torch.linalg.det(u @ vt)
    r = torch.einsum("bde,be,bef->bdf", u, d, vt)          # [B, D, D]
    scale = (s * d).sum(dim=1) / var_x.clamp(min=1e-12)
    return scale[:, None, None] * torch.einsum("bkd,bed->bke", x, r) + mu_t


def pa_mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE (ref HPE-Li utils/eval.py:138-188)."""
    aligned = similarity_transform(pred, target)
    return (aligned - target.float()).square().sum(-1).sqrt().mean()
