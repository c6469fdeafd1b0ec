"""PerUnet baseline: UNet with a Performer-denoised skip connection.

Counterpart of ``wiflow_tpu/models/baselines/perunet.py`` (ref
baseline/PerUnet/perunet.py:342-461):

  [B, 540, 20] -> view (30, 18, 20) -> permute -> [B, 600, 3, 6] (:422-426)
  bilinear 24x24 -> 3-level UNet (600/1200/2400 channels, MaxPool2d)
  Performer (dim 600, depth 3) on the first skip connection  (:383-391)
  ConvTranspose decoders with skip concat
  scale-match convs -> AdaptiveAvgPool(15,15) -> [B, 2, 15, 15] PAM

MM-Fi variant (ref cross_dataset_test/PerUnet/perunet.py:124-241): input
``[B, 3, 114, 10]`` -> ``[B, 1140, 1, 3]`` -> 24x24, the same UNet, global
pool + Linear -> ``[B, 17, 3]`` keypoints.  Layout and names as in
``models/baselines/hpeli.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wiflow_tpu_torch.core.config import resolve_device
from wiflow_tpu_torch.models.baselines.convert import FlaxLayout
from wiflow_tpu_torch.models.baselines.hpeli import conv2d, flax_param
from wiflow_tpu_torch.models.baselines.performer import Performer
from wiflow_tpu_torch.models.baselines.wisppn import resize_bilinear
from wiflow_tpu_torch.models.layers import TorchBatchNorm


class DoubleConv(nn.Module):
    """(3x3 conv + BN + ReLU) x2 (ref perunet.py:342-357)."""

    def __init__(self, cin: int, cout: int, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        for i, c in enumerate((cin, cout)):
            self.register_parameter(f"conv{i}_weight", flax_param(
                (3, 3, c, cout), "he_normal", generator, device))
            self.register_parameter(f"conv{i}_bias", flax_param(
                (cout,), "zeros", generator, device))
            self.add_module(f"bn{i}", TorchBatchNorm(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = conv2d(x, getattr(self, f"conv{i}_weight"),
                       getattr(self, f"conv{i}_bias"))
            x = torch.relu(getattr(self, f"bn{i}")(x))
        return x


def conv_transpose2x2(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """torch ``ConvTranspose2d(k=2, s=2)``, a 2x upsample, as the JAX
    package writes it: ``jax.lax.conv_transpose`` of the HWIO kernel (here
    carried as OIHW), which does not flip it; torch's transposed conv
    takes ``[I, O, kH, kW]`` and flips, so the taps are flipped here."""
    wt = w.to(x.dtype).transpose(0, 1).flip(2, 3)
    y = F.conv_transpose2d(x.movedim(-1, 1), wt, stride=2)
    return y.movedim(1, -1) + b


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.movedim(-1, 1), 2).movedim(1, -1)


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` on ``[B, C, H, W]`` (the JAX package's
    ``_adaptive_avg_pool`` writes out the same windows)."""
    return F.adaptive_avg_pool2d(x, out_size)


class PerUnet(FlaxLayout, nn.Module):
    """UNet + Performer PAM regressor (ref perunet.py:361-460):
    ``[B, 540, 20]`` -> ``[B, pam_channels, pam_size, pam_size]``.  Built
    on ``device`` in eval mode, parameters from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None)."""

    def __init__(self, base: int = 600, pam_channels: int = 2,
                 pam_size: int = 15, input_converter: str = "wiflow",
                 performer_exact: bool = False,
                 compute_dtype: str = "bfloat16", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if input_converter not in ("wiflow", "mmfi"):
            raise ValueError(f"input_converter={input_converter!r}: "
                             f"'wiflow' or 'mmfi'")
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.input_converter, self.pam_size = input_converter, pam_size
        self.compute_dtype = compute_dtype
        cin = 600 if input_converter == "wiflow" else 1140
        self.in_proj = cin != base
        if self.in_proj:
            self.in_proj_weight = flax_param((1, 1, cin, base), "he_normal",
                                             gen, dev)
        c1, c2, c3 = base, base * 2, base * 4

        def double(name, ci, co):
            self.add_module(name, DoubleConv(ci, co, generator=gen,
                                             device=dev))

        def up(name, ci, co):
            self.register_parameter(f"{name}_weight", flax_param(
                (2, 2, ci, co), "he_normal", gen, dev))
            self.register_parameter(f"{name}_bias", flax_param(
                (co,), "zeros", gen, dev))

        double("inc", c1, c1)
        double("down1", c1, c2)
        double("down2", c2, c3)
        double("bot", c3, c3)
        self.performer_sc1 = Performer(dim=c1, depth=3, heads=4, dim_head=64,
                                       exact=performer_exact, generator=gen,
                                       device=dev)
        up("up1", c3, c2)
        double("up_conv1", c2 + c3, c2)
        up("up2", c2, c1)
        double("up_conv2", c1 + c2, c1)
        up("up3", c1, c1)
        double("up_conv3", c1 + c1, c1)
        self.scale1_weight = flax_param((3, 3, c1, 150), "he_normal", gen,
                                        dev)
        self.scale1_bias = flax_param((150,), "zeros", gen, dev)
        self.scale2_weight = flax_param((3, 3, 150, pam_channels),
                                        "he_normal", gen, dev)
        self.scale2_bias = flax_param((pam_channels,), "zeros", gen, dev)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.to(getattr(torch, self.compute_dtype))
        if self.input_converter == "wiflow":
            # [B, 540, 20] -> [B, 30, 18, 20] -> [B, 20, 30, 18]
            # -> [B, 600, 3, 6] (ref :416-426)
            x = x.reshape(b, 30, 18, 20).permute(0, 3, 1, 2)
            x = x.reshape(b, 600, 3, 6)
        else:
            x = x.permute(0, 3, 2, 1).reshape(b, 1140, 1, 3)
        x = resize_bilinear(x.permute(0, 2, 3, 1), (24, 24))
        if self.in_proj:
            x = conv2d(x, self.in_proj_weight)

        x1 = self.inc(x)                                  # 24x24
        x2 = self.down1(_max_pool(x1))                    # 12x12
        x3 = self.down2(_max_pool(x2))                    # 6x6
        bot = self.bot(_max_pool(x3))                     # 3x3

        # Performer-denoised skip 1 (ref :437-441)
        h, w, c1 = x1.shape[1:]
        x1_att = self.performer_sc1(x1.reshape(b, h * w, c1)).reshape(
            b, h, w, c1)

        def up(x, skip, name):
            x = conv_transpose2x2(x, getattr(self, f"{name}_weight"),
                                  getattr(self, f"{name}_bias"))
            return torch.cat([x, skip], dim=-1)

        u = self.up_conv1(up(bot, x3, "up1"))             # 6x6
        u = self.up_conv2(up(u, x2, "up2"))               # 12x12
        u = self.up_conv3(up(u, x1_att, "up3"))           # 24x24
        # scale matching (ref :408-414)
        u = torch.relu(conv2d(u, self.scale1_weight, self.scale1_bias))
        u = conv2d(u, self.scale2_weight, self.scale2_bias)
        u = u.permute(0, 3, 1, 2).float()
        return adaptive_avg_pool(u, self.pam_size)


class PerUnetMMFi(FlaxLayout, nn.Module):
    """MM-Fi PerUnet: the UNet trunk, a global pool, a linear head ->
    ``[B, 17, 3]`` (ref cross_dataset_test/PerUnet/perunet.py:182-241)."""

    def __init__(self, num_keypoints: int = 17, keypoint_dims: int = 3,
                 base: int = 600, performer_exact: bool = False,
                 compute_dtype: str = "bfloat16", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.num_keypoints, self.keypoint_dims = num_keypoints, keypoint_dims
        self.trunk = PerUnet(base, pam_channels=base // 4, pam_size=1,
                             input_converter="mmfi",
                             performer_exact=performer_exact,
                             compute_dtype=compute_dtype, device=dev,
                             generator=gen)
        out = num_keypoints * keypoint_dims
        self.head_weight = flax_param((base // 4, out), "xavier_normal", gen,
                                      dev)
        self.head_bias = flax_param((out,), "zeros", gen, dev)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.trunk(x).reshape(x.shape[0], -1)     # [B, base // 4]
        # an fp32 feature times the head's parameters, in their dtype
        w = self.head_weight
        out = feats.to(w.dtype) @ w + self.head_bias
        return out.reshape(x.shape[0], self.num_keypoints,
                           self.keypoint_dims).float()
