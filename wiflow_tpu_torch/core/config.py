"""Model configuration for the port's serving path.

A copy of the fields of ``wiflow_tpu.core.config.ModelConfig`` that the
eval module and ``models/fast.py`` read, with the same defaults (the
reference architecture, ref models/pose_model.py:16-53).  The JAX
package's config module is not imported: importing anything under
``wiflow_tpu`` runs its package ``__init__``, which loads JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """WiFlow model hyperparameters (serving subset)."""

    num_subcarriers: int = 540
    window_size: int = 20
    num_keypoints: int = 15
    keypoint_dims: int = 2
    tcn_channels: Sequence[int] = (540, 440, 340, 240)
    tcn_kernel_size: int = 3
    tcn_groups: int = 20
    conv_channels: Sequence[int] = (8, 16, 32, 64)
    attention_groups: int = 8
    # compute dtype for the forward pass; parameters stay fp32
    compute_dtype: str = "bfloat16"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``device=None`` means ``"cuda"``.  Without a usable CUDA device this
    raises instead of dropping to the CPU; the CPU is used only when the
    caller passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wiflow_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
