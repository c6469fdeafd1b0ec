"""Eval-mode BatchNorm with torch numerics (eps 1e-5), as plain functions.

Counterpart of ``wiflow_tpu/ops/norm.py::batch_norm_eval`` and of the
``bn_affine`` fold in ``wiflow_tpu/ops/pallas/axial_attention.py:85-88``.
Train-mode BatchNorm belongs to the training slice and is not here.
"""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-5


def bn_affine(gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor, eps: float = EPS
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN as ``(scale, bias)``: ``y = scale * x + bias`` (fp32)."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def folded_bn(state_dict, prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bn_affine`` of the BatchNorm stored under ``prefix`` in a torch
    ``state_dict`` (``weight``, ``bias``, ``running_mean``, ``running_var``)."""
    return bn_affine(state_dict[f"{prefix}.weight"],
                     state_dict[f"{prefix}.bias"],
                     state_dict[f"{prefix}.running_mean"],
                     state_dict[f"{prefix}.running_var"])


def batch_norm_eval(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Inference-mode BN over the last (channel) axis from running
    statistics, applied in ``x.dtype``.

    The per-channel scale is computed in fp32 and cast to ``x.dtype``, as
    the JAX package does, so bf16 activations see the same rounding.
    """
    a = (gamma.float() * torch.rsqrt(var.float() + EPS)).to(x.dtype)
    return (x - mean.to(x.dtype)) * a + beta.to(x.dtype)
