"""PCK and MPJPE with the reference's semantics.

Counterpart of ``wiflow_tpu/metrics/metrics.py`` (ref
utils/metrics.py:3-46): the "torso" normalizer is the distance between
keypoints 2 and 12, clamped to at least 0.01; PCK averages over every
keypoint of every sample at once; keypoints are in metres, so MPJPE is.
``pck_correct_fractions``, ``pck_per_keypoint``, ``mpjpe`` and the
functions ``pckh_fractions_fn`` makes return device tensors (no host
sync); ``calculate_pck`` and ``calculate_mpjpe`` return host floats, and
the reference's per-joint evaluators ``compute_pck_pckh`` (17 keypoints),
``compute_pck_pckh_hpeli``, ``compute_pck_pckh_18`` and
``compute_pck_pckh_15`` numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
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


def _coord_major_to_kp(x) -> torch.Tensor:
    """The reference's layout ``[n, D, K]`` -> ``[n, K, D]``; ``[n, K, 2|3]``
    passes through.  As evaluation.py:66-68 does, a middle axis of 2 or 3
    (coordinates) before a last axis that is neither is taken for
    coordinate-major."""
    x = torch.as_tensor(x)
    if x.shape[1] in (2, 3) and x.shape[2] not in (2, 3):
        return x.transpose(1, 2)
    return x


def _pckh(dt_kpts, gt_kpts, thr: float, scale_a: int, scale_b: int,
          clamp: Optional[float] = None) -> np.ndarray:
    return pck_per_keypoint(_coord_major_to_kp(dt_kpts),
                            _coord_major_to_kp(gt_kpts), thr, scale_a,
                            scale_b, clamp).cpu().numpy()


def compute_pck_pckh(dt_kpts, gt_kpts, thr: float) -> np.ndarray:
    """17-keypoint per-joint PCK, WPformer variant (ref
    baseline/WPformer/evaluation.py:6-31): the scale is the target's
    distance between keypoints 5 and 12, not clamped.  Takes ``[n, 2, 17]``
    or ``[n, 17, 2]``; returns 18 numbers in percent, the last the
    overall PCK."""
    return _pckh(dt_kpts, gt_kpts, thr, 5, 12)


def compute_pck_pckh_hpeli(dt_kpts, gt_kpts, thr: float) -> np.ndarray:
    """17-keypoint per-joint PCK, HPE-Li variant: scale keypoints 1 and 11
    (ref cross_dataset_test/HPE-Li/utils/eval.py:44-76)."""
    return _pckh(dt_kpts, gt_kpts, thr, 1, 11)


def compute_pck_pckh_18(dt_kpts, gt_kpts, thr: float) -> np.ndarray:
    """18-keypoint (WiPose) per-joint PCK: scale keypoints 6 and 13 (ref
    baseline/WPformer/evaluation.py:33-57)."""
    return _pckh(dt_kpts, gt_kpts, thr, 6, 13)


def compute_pck_pckh_15(dt_kpts, gt_kpts, thr: float) -> np.ndarray:
    """15-keypoint (Setting 1) per-joint PCK: scale keypoints 2 and 12,
    clamped below at 1e-6 (ref baseline/WPformer/evaluation.py:60-83)."""
    return _pckh(dt_kpts, gt_kpts, thr, 2, 12, clamp=1e-6)


def pckh_fractions_fn(scale_a: int, scale_b: int,
                      clamp: Optional[float] = None):
    """A ``pck_fn(pred, target, thresholds)`` for the trainer's hooks with
    the ``compute_pck_pckh`` normalization: target keypoints ``scale_a``
    and ``scale_b``, x and y only, clamped below at ``clamp`` where given
    (the HPE-Li robustness script's, ref HPE-Li/main.py:215-226, scale
    keypoints 1 and 11).  It returns ``[len(thresholds)]`` fractions."""
    def fn(pred: torch.Tensor, target: torch.Tensor,
           thresholds: Sequence[float]) -> torch.Tensor:
        p = _as_keypoints(pred)[..., :2].float()
        t = _as_keypoints(target)[..., :2].float()
        scale = torch.sqrt(((t[:, scale_a] - t[:, scale_b]) ** 2).sum(-1))
        if clamp is not None:
            scale = scale.clamp(min=clamp)
        dist = torch.sqrt(((p - t) ** 2).sum(-1)) / scale[:, None]
        thr = device_constant(thresholds, p.device, torch.float32)
        return (dist[None] <= thr[:, None, None]).float().mean(dim=(1, 2))
    return fn


def mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error."""
    pred = _as_keypoints(pred).float()
    target = _as_keypoints(target).float()
    return torch.sqrt(((pred - target) ** 2).sum(-1)).mean()


def calculate_mpjpe(pred, target) -> float:
    return float(mpjpe(torch.as_tensor(pred), torch.as_tensor(target)))
