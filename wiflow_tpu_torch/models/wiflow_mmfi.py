"""WiFlow re-dimensioned for MM-Fi, as an ``nn.Module``: ``[B, 3, 114, 10]``
CSI -> ``[B, 17, 3]`` pose.

Counterpart of ``wiflow_tpu/models/wiflow_mmfi.py`` (ref
cross_dataset_test/WiFlow/wiflow.py:441-530), assembled from the blocks of
``models/wiflow.py``:

  flatten antennas: [B, 3, 114, 10] -> [B, T=10, 342]
  TCN 342 -> [342, 306, 288], groups 18
  1x1 projection 288 -> 272 (no bias) + BN + SiLU
  ConvBlock1 (1 -> 8) + 4 stride-2 blocks -> [B, 10, 17, 64]
  dual axial attention (groups 8) on [B, H=17, W=10, 64]
  the LAST time step, 1x1 conv 64 -> 32 + BN + SiLU, 1x1 conv 32 -> 3

Parameter and buffer names are the reference torch ``state_dict`` names
(``models/torch_compat.py::wiflow_mmfi_spec``): ``att``, not
``attention``; ``tcn_proj.0/.1``; ``final_conv.0/.1/.3``.  In eval mode
every step is a stock torch op: this is the plain reference of
``models/fast.py::fast_forward_mmfi``.  Train mode is that of the blocks
(batch statistics, dropout from ``dropout_generator``, the attention's
train kernels).  With ``tcn_train_impl`` / ``conv_train_impl`` set to
``"fused"`` (or ``"auto"`` on a CUDA device) the train-mode TCN and conv
stack run through the ``stage`` and ``join`` kernels of
``ops/kernels/stage_fused.py``, as in ``WiFlowPoseModel``; the projection
between them stays stock ops, as in the JAX model.  Parameters, buffers,
dropout draws and values are those of the stock-op path, and eval mode
ignores the switches.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from wiflow_tpu_torch.core.config import (
    TRAIN_IMPLS, resolve_device, use_fused,
)
from wiflow_tpu_torch.models.layers import TorchBatchNorm, silu
from wiflow_tpu_torch.models.wiflow import (
    ConvBlock, DualAxialAttention, TCNStack, reset_conv_parameters,
)
from wiflow_tpu_torch.ops.conv import conv1x1_2d, pointwise_conv1d


@dataclasses.dataclass(frozen=True)
class MMFiModelConfig:
    """Hyperparameters of the MM-Fi model: the fields of the JAX package's
    ``MMFiModelConfig`` that the port reads, with its defaults.  Its
    ``tcn_matmul`` and ``attention_module_impl`` are TPU matters and have
    no counterpart."""

    num_antennas: int = 3
    num_subcarriers: int = 114
    window_size: int = 10
    num_keypoints: int = 17
    keypoint_dims: int = 3
    tcn_channels: Sequence[int] = (342, 306, 288)
    tcn_proj_channels: int = 272
    tcn_kernel_size: int = 3
    tcn_groups: int = 18                     # ref wiflow.py:167
    conv_channels: Sequence[int] = (8, 16, 32, 64)
    attention_groups: int = 8
    dropout: float = 0.3                     # ref wiflow.py:1185
    conv_dropout: float = 0.3
    compute_dtype: str = "bfloat16"
    # Train-mode lowering switches, as in ``ModelConfig``: "xla" (stock
    # torch ops), "fused" (the TCN or the conv stack through the stage and
    # join kernels) or "auto" (fused on a CUDA device).
    tcn_train_impl: str = "xla"
    conv_train_impl: str = "xla"

    def __post_init__(self):
        for name in ("tcn_train_impl", "conv_train_impl"):
            if getattr(self, name) not in TRAIN_IMPLS:
                raise ValueError(f"{name}={getattr(self, name)!r}: one of "
                                 f"{TRAIN_IMPLS}")

    @property
    def input_channels(self) -> int:
        return self.num_antennas * self.num_subcarriers   # 342

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


class WiFlowMMFiModel(nn.Module):
    """CSIPoseEstimationModel rebuild (ref wiflow.py:441-530).

    Built on ``device`` (CUDA unless ``device="cpu"``) in eval mode, with
    parameters drawn from ``generator`` as ``WiFlowPoseModel`` draws them;
    ``dropout_generator``, on the model's device, draws every dropout mask
    in train mode.
    """

    def __init__(self, config: MMFiModelConfig = MMFiModelConfig(), *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        cfg = self.config = config
        dev = resolve_device(device)
        gen = self.dropout_generator = torch.Generator(device=dev)
        self.tcn = TCNStack(cfg.input_channels, tuple(cfg.tcn_channels),
                            cfg.tcn_kernel_size, cfg.tcn_groups, cfg.dropout,
                            gen, device=dev, train_impl=cfg.tcn_train_impl)
        self.tcn_proj = nn.Sequential(
            nn.Conv1d(cfg.tcn_channels[-1], cfg.tcn_proj_channels, 1,
                      bias=False, device=dev),
            TorchBatchNorm(cfg.tcn_proj_channels, device=dev), nn.SiLU())
        chans = tuple(cfg.conv_channels)
        fused = use_fused(cfg.conv_train_impl, dev)
        self.up = ConvBlock(1, chans[0], 1, cfg.conv_dropout, gen, device=dev,
                            fused=fused)
        blocks, n_in = [], chans[0]
        for n_out in chans:
            blocks.append(ConvBlock(n_in, n_out, 2, cfg.conv_dropout, gen,
                                    device=dev, fused=fused))
            n_in = n_out
        self.residual_blocks = nn.ModuleList(blocks)
        c = chans[-1]
        self.att = DualAxialAttention(c, cfg.attention_groups, device=dev)
        self.final_conv = nn.Sequential(
            nn.Conv2d(c, 32, 1, device=dev), TorchBatchNorm(32, device=dev),
            nn.SiLU(), nn.Conv2d(32, cfg.keypoint_dims, 1, device=dev))
        reset_conv_parameters(self, generator)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if x.ndim != 4 or tuple(x.shape[1:]) != (
                cfg.num_antennas, cfg.num_subcarriers, cfg.window_size):
            raise ValueError(
                f"WiFlowMMFiModel expects [B, {cfg.num_antennas}, "
                f"{cfg.num_subcarriers}, {cfg.window_size}] MM-Fi CSI, got "
                f"{tuple(x.shape)}")
        b = x.shape[0]
        x = x.to(cfg.dtype).reshape(b, cfg.input_channels, cfg.window_size)
        x = x.transpose(1, 2)                             # [B, 10, 342]
        if self.training and self.tcn.network[0].fused:
            x = x.contiguous()        # once, for the stages that read it
        x = self.tcn(x)                                   # [B, 10, 288]
        p = self.tcn_proj
        x = silu(p[1](pointwise_conv1d(x, p[0].weight)))  # [B, 10, 272]
        x = self.up(x[..., None])
        for blk in self.residual_blocks:
            x = blk(x)                                    # [B, 10, 17, 64]
        x = self.att(x.transpose(1, 2))                   # [B, 17, 10, 64]
        x = x[:, :, -1:, :]                               # last time step
        f = self.final_conv
        x = silu(f[1](conv1x1_2d(x, f[0].weight, f[0].bias)))
        x = conv1x1_2d(x, f[3].weight, f[3].bias)         # [B, 17, 1, 3]
        return x[:, :, 0, :].float()
