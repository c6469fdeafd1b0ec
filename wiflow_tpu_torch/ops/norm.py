"""BatchNorm with torch numerics (eps 1e-5, momentum 0.1) and dropout, as
plain functions.

Counterpart of ``wiflow_tpu/ops/norm.py`` and of the ``bn_affine`` fold in
``wiflow_tpu/ops/pallas/axial_attention.py:85-88``.  Activations are
channel-last.  Train-mode BN normalizes with the biased batch variance and
moves the running statistics with the unbiased one:
``running <- 0.9 * running + 0.1 * batch``.  Under data parallelism
(``parallel/mesh.py``) the batch is the global one: the moments come from
per-channel sums all-reduced over the ranks, and a dropout mask is drawn
for the global batch, each rank keeping its rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from wiflow_tpu_torch.parallel.mesh import global_sums, local_rows, step_world

EPS = 1e-5
MOMENTUM = 0.1


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


def running_update(running_mean: torch.Tensor, running_var: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, count: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch's running-statistics step from a batch's biased ``var`` over
    ``count`` elements per channel."""
    unbiased = var * (count / max(count - 1, 1))
    return ((1.0 - MOMENTUM) * running_mean + MOMENTUM * mean,
            (1.0 - MOMENTUM) * running_var + MOMENTUM * unbiased)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BN over the last axis.

    Returns ``(y, new_running_mean, new_running_var)``; ``y`` is
    differentiable through the batch moments, the running statistics are
    detached.  The moments are fp32, from the per-channel sums of ``x`` and
    of its square over every rank (:func:`global_sums`), the variance
    ``E[x^2] - mean^2`` (the JAX formula, kept for parity).
    """
    axes = tuple(range(x.ndim - 1))
    xf = x.float()
    sums, count = global_sums(
        torch.stack([xf.sum(dim=axes), (xf * xf).sum(dim=axes)]),
        x.numel() // x.shape[-1])
    mom = sums / count
    mean = mom[0]
    var = mom[1] - mean * mean
    a = (gamma.float() * torch.rsqrt(var + EPS)).to(x.dtype)
    y = (x - mean.to(x.dtype)) * a + beta.to(x.dtype)
    new_mean, new_var = running_update(running_mean, running_var,
                                       mean.detach(), var.detach(), count)
    return y, new_mean, new_var


def bn_vectors_from_sums(sums: torch.Tensor, count: int, gamma: torch.Tensor,
                         beta: torch.Tensor):
    """Train-mode BN from per-channel sums instead of the tensor.

    ``sums [2, C]`` holds the sum and the sum of squares of ``count``
    elements per channel.  Returns ``(m, a, b, var)``: the apply vectors
    of ``y = (x - m) * a + b`` in fp32 (``m`` the batch mean,
    ``a = gamma * rsqrt(var + eps)``, ``b = beta``; whoever applies them
    rounds them to the compute dtype, which reproduces
    :func:`batch_norm_train`) and the batch's biased variance.  A
    few ops on ``[C]``-sized tensors, differentiable in ``sums``, ``gamma``
    and ``beta`` (counterpart of the ``moments=`` entry of
    ``wiflow_tpu/models/layers.py::TorchBatchNorm``).
    """
    mom = sums / count
    mean = mom[0]
    var = torch.addcmul(mom[1], mean, mean, value=-1.0)
    a = gamma.float() * torch.rsqrt(var + EPS)
    return mean, a, beta.float(), var


def keep_mask(shape, rate: float, device: torch.device,
              generator: torch.Generator):
    """The bool keep-mask :func:`dropout` and :func:`dropout2d` draw for
    ``shape`` (the same bits from the same generator state), or None when
    ``rate`` drops nothing."""
    if rate <= 0.0:
        return None
    return _keep_mask(shape, 1.0 - rate, device, generator)


def _keep_mask(shape, keep: float, device: torch.device,
               generator: torch.Generator) -> torch.Tensor:
    """Drawn for the global batch (``shape[0]`` rows a rank), this rank's
    rows kept."""
    full = (shape[0] * step_world(), *shape[1:])
    return local_rows(torch.rand(full, generator=generator,
                                 device=device) < keep)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Elementwise dropout with inverted scaling (torch ``nn.Dropout``),
    its keep bits drawn from ``generator`` (on ``x``'s device)."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, x.device, generator)
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def dropout2d(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Channel dropout (torch ``nn.Dropout2d``) on ``x [B, H, W, C]``: one
    keep bit per (sample, channel), shared over (H, W)."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    b, _, _, c = x.shape
    mask = _keep_mask((b, 1, 1, c), keep, x.device, generator)
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
