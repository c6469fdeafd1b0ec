"""Pose loss: position term + bone-length consistency term.

Counterpart of ``wiflow_tpu/losses/pose_loss.py`` (ref
losses/pose_loss.py:5-88): smooth-L1 with beta 0.1 on positions and 0.05
on the 14 bone lengths (``sqrt(sum(diff^2) + 1e-8)``), bone weight 0.2;
'mse' and 'l1' variants.  Computed in fp32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from wiflow_tpu_torch.core.config import (
    LossConfig, SKELETON_CONNECTIONS, device_constant,
)


def smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    """torch ``F.smooth_l1_loss`` elementwise (mean-reduced by the caller)."""
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def bone_lengths(keypoints: torch.Tensor,
                 connections: Sequence[Tuple[int, int]] = SKELETON_CONNECTIONS
                 ) -> torch.Tensor:
    """Per-edge bone lengths ``[..., E]`` of ``[..., K, D]`` keypoints."""
    dev = keypoints.device
    starts = device_constant([s for s, _ in connections], dev, torch.long)
    ends = device_constant([e for _, e in connections], dev, torch.long)
    vec = (keypoints.index_select(-2, ends)
           - keypoints.index_select(-2, starts))
    return torch.sqrt((vec * vec).sum(-1) + 1e-8)


def pose_loss(pred: torch.Tensor, target: torch.Tensor,
              cfg: LossConfig = LossConfig(),
              connections: Sequence[Tuple[int, int]] = SKELETON_CONNECTIONS
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its parts for ``[B, K, D]`` (or ``[B, K*2]``)
    predictions and targets."""
    if pred.ndim == 2:
        pred = pred.reshape(pred.shape[0], -1, 2)
    if target.ndim == 2:
        target = target.reshape(target.shape[0], -1, 2)
    pred, target = pred.float(), target.float()

    diff = pred - target
    bd = bone_lengths(pred, connections) - bone_lengths(target, connections)
    if cfg.loss_type == "mse":
        position, bone = (diff * diff).mean(), (bd * bd).mean()
    elif cfg.loss_type == "l1":
        position, bone = diff.abs().mean(), bd.abs().mean()
    elif cfg.loss_type == "smooth_l1":
        position = smooth_l1(diff, cfg.position_beta).mean()
        bone = smooth_l1(bd, cfg.bone_beta).mean()
    else:
        raise ValueError(f"Unknown loss type: {cfg.loss_type}")
    total = cfg.position_weight * position + cfg.bone_weight * bone
    return total, {"position": position, "bone": bone}
