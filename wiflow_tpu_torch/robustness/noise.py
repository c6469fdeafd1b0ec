"""Noise injection for the robustness studies.

Counterpart of ``wiflow_tpu/robustness/noise.py`` (ref cross_dataset_test/
HPE-Li/utils/noise.py):

  * AWGN with std = noise_level * the signal's dynamic range (:12-29),
  * salt-and-pepper: noise_level * size entries, half set to 1 and half to
    0, drawn with replacement as the reference draws them (:31-53).

:func:`add_awgn` and :func:`add_salt_and_pepper_noise` are host numpy,
copied from the JAX package: the same ``np.random.Generator`` gives the same
bytes.  :func:`add_awgn_torch` and :func:`add_salt_and_pepper_torch` are the
counterparts of its ``add_awgn_jax`` / ``add_salt_and_pepper_jax``: tensor
functions on the input's device, drawing from a ``torch.Generator`` on that
device.  Their draws are not JAX's, so only their distributions match.
"""

from __future__ import annotations

import numpy as np
import torch


def add_awgn(signal: np.ndarray, noise_level: float,
             rng: np.random.Generator | None = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    std = noise_level * (np.max(signal) - np.min(signal))
    return signal + rng.normal(0.0, std, signal.shape).astype(signal.dtype)


def add_salt_and_pepper_noise(signal: np.ndarray, noise_level: float,
                              rng: np.random.Generator | None = None
                              ) -> np.ndarray:
    rng = rng or np.random.default_rng()
    out = np.copy(signal)
    num = int(np.floor(noise_level * signal.size * 0.5))
    for value in (1.0, 0.0):
        coords = tuple(rng.integers(0, dim, num) for dim in signal.shape)
        out[coords] = value
    return out


def add_awgn_torch(x: torch.Tensor, noise_level: float,
                   generator: torch.Generator) -> torch.Tensor:
    """AWGN of std ``noise_level * (max(x) - min(x))`` on ``x``'s device
    (no host sync: the range stays a device tensor)."""
    std = noise_level * (x.max() - x.min())
    noise = torch.randn(x.shape, generator=generator, device=x.device,
                        dtype=x.dtype)
    return x + noise * std


def add_salt_and_pepper_torch(x: torch.Tensor, noise_level: float,
                              generator: torch.Generator) -> torch.Tensor:
    """Each entry independently set to 1 or to 0 with probability
    ``noise_level / 2`` each (the dense equivalent of the reference's index
    draws)."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    half = noise_level / 2.0
    x = torch.where(u < half, torch.ones_like(x), x)
    return torch.where((u >= half) & (u < noise_level), torch.zeros_like(x),
                       x)
