"""CSI augmentation on the batch's device, drawn from a ``torch.Generator``.

Counterpart of ``wiflow_tpu/data/augment.py`` (ref utils/augmentation.py:
3-35 and the calling policy of train.py:187-193: probabilities 0.6 / 0.6 /
0.5, from the second epoch on).  Every random choice, the Bernoulli gates
included, is a device tensor applied with ``torch.where``: no Python
branch on a drawn value, so a train step that augments never waits on the
device.  The draws come from the caller's generator (on the batch's
device), so a seed fixes them.

Semantics kept from the reference, as the JAX package keeps them:
  * the trunk masks through a permute (train.py:188), so on ``[B, S=540,
    T=20]`` windows ``subcarrier_masking`` masks 1-2 spans of 5-9
    SUBCARRIERS, filled with each time step's mean over subcarriers;
  * span starts are uniform over ``[0, length - len)``, never clamped;
  * the fill mean is recomputed from the partly masked tensor for the
    second span (``apply_mask_spans``, the deterministic core);
  * noise is N(0, 1) x ``noise_level`` x the batch's unbiased std; scaling
    multiplies the whole batch by one U(0.9, 1.1) factor.

The work is done in fp32 and the result returned in the input's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _uniform(shape, gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=dev)


def time_masking(x: torch.Tensor, generator: torch.Generator,
                 mask_ratio: float = 0.3,
                 mask_len_range: Tuple[int, int] = (5, 10)) -> torch.Tensor:
    """Span masking along the LAST axis of ``[B, C, T]``: per sample with
    probability ``mask_ratio``, 1-2 spans of ``randint(*mask_len_range)``
    steps take each channel's mean over the last axis."""
    b, _, t = x.shape
    dev = x.device
    apply = _uniform((b,), generator, dev) < mask_ratio
    num_masks = torch.randint(1, 3, (b,), generator=generator, device=dev)
    lens = torch.randint(mask_len_range[0], mask_len_range[1], (b, 2),
                         generator=generator, device=dev)
    starts = torch.floor(_uniform((b, 2), generator, dev) * (t - lens)).long()
    return apply_mask_spans(x, apply, num_masks, lens, starts)


def apply_mask_spans(x: torch.Tensor, apply: torch.Tensor,
                     num_masks: torch.Tensor, lens: torch.Tensor,
                     starts: torch.Tensor) -> torch.Tensor:
    """The deterministic core of :func:`time_masking`: up to 2 spans per
    sample along the last axis of ``[B, C, T]``, in order, each filled with
    the per-channel mean of the tensor as the spans before it left it.
    ``apply [B]`` bool, ``num_masks [B]`` (1 or 2), ``lens``, ``starts``
    ``[B, 2]``.  The mean is the sum times ``1 / T``, as XLA computes the
    JAX package's."""
    t = x.shape[-1]
    pos = torch.arange(t, device=x.device)[None, :]
    for j in range(2):
        span = (pos >= starts[:, j:j + 1]) & \
            (pos < (starts[:, j] + lens[:, j])[:, None])           # [B, T]
        masked = span & (apply & (num_masks > j))[:, None]
        mean = x.sum(dim=2, keepdim=True) * (1.0 / t)
        x = torch.where(masked[:, None, :], mean, x)
    return x


def add_noise(x: torch.Tensor, generator: torch.Generator,
              noise_level: float = 0.05) -> torch.Tensor:
    """``x + N(0, 1) * noise_level * std(x)`` (global unbiased std)."""
    noise = torch.randn(x.shape, generator=generator, device=x.device,
                        dtype=x.dtype)
    return x + noise * (noise_level * x.std())


def random_scaling(x: torch.Tensor, generator: torch.Generator,
                   scale_range: Tuple[float, float] = (0.9, 1.1)
                   ) -> torch.Tensor:
    """With probability 0.5, ``x`` times one factor ~ U(scale_range)."""
    lo, hi = scale_range
    apply = _uniform((), generator, x.device) < 0.5
    scale = lo + (hi - lo) * _uniform((), generator, x.device)
    return torch.where(apply, x * scale, x)


def subcarrier_masking(x: torch.Tensor, generator: torch.Generator,
                       mask_ratio: float = 0.3,
                       mask_len_range: Tuple[int, int] = (5, 10)
                       ) -> torch.Tensor:
    """ref train.py:188 on ``[B, S, T]`` CSI: :func:`time_masking` through
    a permute, so spans of 5-9 consecutive subcarriers take each time
    step's mean over subcarriers."""
    return time_masking(x.transpose(1, 2), generator, mask_ratio,
                        mask_len_range).transpose(1, 2)


def augment_batch(x: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """The train.py:187-193 policy on ``[B, S=540, T=20]`` batches:
    subcarrier-span masking with p 0.6, noise (0.02) with p 0.6, scaling
    with p 0.5.  The caller skips the first epoch, as the reference does."""
    dev = x.device
    out = x.float()
    out = torch.where(_uniform((), generator, dev) < 0.6,
                      subcarrier_masking(out, generator, mask_ratio=0.3),
                      out)
    out = torch.where(_uniform((), generator, dev) < 0.6,
                      add_noise(out, generator, noise_level=0.02), out)
    out = torch.where(_uniform((), generator, dev) < 0.5,
                      random_scaling(out, generator, (0.9, 1.1)), out)
    return out.to(x.dtype)
