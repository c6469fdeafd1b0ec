"""Traditional time-axis denoising filters.

Counterpart of ``wiflow_tpu/robustness/filters.py`` (ref cross_dataset_test/
HPE-Li/traditional_filter/{gaussian_filter,mean_filter}.py): smoothing along
the time axis of ``[B, C, S, T]`` CSI with edge padding, in fp32, on the
input's device (a numpy input goes to the CPU).  The Gaussian kernel's sigma
is the standard deviation of the whole input, a quirk of the reference that
the JAX package keeps.
"""

from __future__ import annotations

import torch


def _as_fp32(data) -> torch.Tensor:
    return torch.as_tensor(data).to(torch.float32)


def _smooth_time(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    k = kernel.shape[0]
    pad = k // 2
    edge = (*x.shape[:-1], pad)
    xp = torch.cat([x[..., :1].expand(edge), x, x[..., -1:].expand(edge)],
                   dim=-1)
    t = x.shape[-1]
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + kernel[j] * xp[..., j:j + t]
    return out


def gaussian_filter(data, kernel_size: int = 3) -> torch.Tensor:
    """Gaussian time smoothing; sigma = std(data) (ref gaussian_filter.py)."""
    x = _as_fp32(data)
    pad = kernel_size // 2
    sigma = x.std(correction=0)
    grid = torch.linspace(-pad, pad, kernel_size, device=x.device)
    kernel = torch.exp(-0.5 * (grid / sigma) ** 2)
    return _smooth_time(x, kernel / kernel.sum())


def mean_filter(data, kernel_size: int = 3) -> torch.Tensor:
    """Moving-average time smoothing (ref mean_filter.py)."""
    x = _as_fp32(data)
    kernel = torch.full((kernel_size,), 1.0 / kernel_size,
                        dtype=torch.float32, device=x.device)
    return _smooth_time(x, kernel)
