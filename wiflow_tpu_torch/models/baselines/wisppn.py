"""WiSPPN baseline: ResNet PAM regressor.

Counterpart of ``wiflow_tpu/models/baselines/wisppn.py`` (ref
baseline/WiSPPN/wisppn.py:269-418):

  convert_csi_format: [B, 540, 20] -> [B, 600, 3, 6]   (:269-298)
  bilinear upsample to 120x120                          (:378)
  ResNet of BasicBlocks, layers [2,2,2,2], widths 600/600/1024/1024
  conv decode -> [B, 2, 15, 15] pose-adjacency matrix   (:352-394)
  keypoints live on the PAM diagonal                    (:396-413)

The MM-Fi variant reshapes ``[B, 3, 114, 10]`` -> ``[B, 1140, 1, 3]`` and
emits a 3x17x17 PAM (ref cross_dataset_test/WiSPPN/wisppn.py:36-61,
98-158).  Layout and names as in ``models/baselines/hpeli.py``.

Two places where torch's defaults are not the JAX package's:

* the stride-2 3x3 convs pad as XLA's ``"SAME"`` does, (0, 1) on the
  120x120 map, not torch's (1, 1): ``conv2d`` pads explicitly;
* ``jax.image.resize(..., "bilinear")`` is ``F.interpolate(mode=
  "bilinear", align_corners=False)`` only when it upsamples, which every
  resize here does (3x6 -> 120x120, 1x3 -> 120x120, 15 -> 17).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wiflow_tpu_torch.core.config import resolve_device
from wiflow_tpu_torch.models.baselines.convert import FlaxLayout
from wiflow_tpu_torch.models.baselines.hpeli import conv2d, flax_param
from wiflow_tpu_torch.models.layers import TorchBatchNorm


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` over the two axes before
    the last of a channel-last ``x``; it must upsample (half-pixel
    centres, no antialiasing: the two agree only then)."""
    if any(s < n for s, n in zip(size, x.shape[1:3])):
        raise ValueError(f"resize_bilinear upsamples only: {tuple(x.shape)} "
                         f"-> {tuple(size)}")
    y = F.interpolate(x.movedim(-1, 1), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.movedim(1, -1)


def convert_csi_format(x: torch.Tensor) -> torch.Tensor:
    """[B, 540, 20] -> [B, 600, 3, 6] '(time x subcarrier, tx, rx)' view
    (ref wisppn.py:269-298)."""
    b = x.shape[0]
    x = x.reshape(b, 2, 30, 3, 3, 20).permute(0, 1, 5, 2, 3, 4)
    return x.reshape(b, 600, 3, 6)


def convert_csi_format_mmfi(x: torch.Tensor) -> torch.Tensor:
    """[B, 3, 114, 10] -> [B, 1140, 1, 3] (ref cross_dataset_test/
    WiSPPN/wisppn.py:36-61)."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], 1140, 1, 3)


class BasicBlock(nn.Module):
    """3x3-3x3 residual block (ref wisppn.py:309-333); a 3x3 conv + BN
    shortcut where the stride or the width changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.stride = stride
        self.conv1_weight = flax_param((3, 3, cin, cout), "he_normal",
                                       generator, device)
        self.bn1 = TorchBatchNorm(cout, device=device)
        self.conv2_weight = flax_param((3, 3, cout, cout), "he_normal",
                                       generator, device)
        self.bn2 = TorchBatchNorm(cout, device=device)
        self.down = stride != 1 or cin != cout
        if self.down:
            self.down_weight = flax_param((3, 3, cin, cout), "he_normal",
                                          generator, device)
            self.down_bn = TorchBatchNorm(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = (self.stride, self.stride)
        y = torch.relu(self.bn1(conv2d(x, self.conv1_weight, stride=s)))
        y = self.bn2(conv2d(y, self.conv2_weight))
        if self.down:
            x = self.down_bn(conv2d(x, self.down_weight, stride=s))
        return torch.relu(y + x)


class WiSPPN(FlaxLayout, nn.Module):
    """PAM-regressing ResNet (ref wisppn.py:335-394): ``[B, 540, 20]`` ->
    ``[B, 2, 15, 15]`` (``input_converter="mmfi"``: ``[B, 3, 114, 10]`` ->
    ``[B, 3, 17, 17]`` with ``pam_channels=3, pam_size=17``).  Built on
    ``device`` in eval mode, parameters from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (600, 600, 1024, 1024),
                 input_converter: str = "wiflow", pam_channels: int = 2,
                 pam_size: int = 15, compute_dtype: str = "bfloat16", *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if input_converter not in ("wiflow", "mmfi"):
            raise ValueError(f"input_converter={input_converter!r}: "
                             f"'wiflow' or 'mmfi'")
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.input_converter, self.pam_size = input_converter, pam_size
        self.compute_dtype = compute_dtype
        cin = 600 if input_converter == "wiflow" else 1140
        self.conv1_weight = flax_param((3, 3, cin, cin), "he_normal", gen, dev)
        self.bn1 = TorchBatchNorm(cin, device=dev)
        c = cin
        for li, (n, width) in enumerate(zip(layers, widths)):
            for bi in range(n):
                stride = 2 if li > 0 and bi == 0 else 1
                self.add_module(f"layer{li + 1}_{bi}", BasicBlock(
                    c, width, stride, generator=gen, device=dev))
                c = width
        self.blocks = [f"layer{li + 1}_{bi}"
                       for li, n in enumerate(layers) for bi in range(n)]
        for i, cout in enumerate((256, 64)):
            self.register_parameter(f"decode_conv{i}_weight", flax_param(
                (3, 3, c, cout), "he_normal", gen, dev))
            self.add_module(f"decode_bn{i}", TorchBatchNorm(cout, device=dev))
            c = cout
        self.decode_out_weight = flax_param((1, 1, 64, pam_channels),
                                            "he_normal", gen, dev)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(getattr(torch, self.compute_dtype))
        x = (convert_csi_format(x) if self.input_converter == "wiflow"
             else convert_csi_format_mmfi(x))
        x = resize_bilinear(x.permute(0, 2, 3, 1), (120, 120))
        x = torch.relu(self.bn1(conv2d(x, self.conv1_weight)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        for i in range(2):
            x = conv2d(x, getattr(self, f"decode_conv{i}_weight"))
            x = torch.relu(getattr(self, f"decode_bn{i}")(x))
        x = conv2d(x, self.decode_out_weight).float()  # [B, 15, 15, C]
        if x.shape[1] != self.pam_size:
            x = resize_bilinear(x, (self.pam_size, self.pam_size))
        return x.permute(0, 3, 1, 2)                    # [B, C, K, K]


def extract_keypoints_from_pam(pam: torch.Tensor) -> torch.Tensor:
    """PAM diagonal -> keypoints [B, K, C] (ref wisppn.py:396-413)."""
    return torch.diagonal(pam, dim1=-2, dim2=-1).transpose(-1, -2)


def keypoints_to_pam(kp: torch.Tensor, confidence: float = 1.0
                     ) -> torch.Tensor:
    """PAM labels from keypoints (for synthetic data): diagonal = coords,
    off-diagonal = pairwise midpoints, plus constant confidence channels.
    [B, K, C] -> [B, 2C, K, K]."""
    b, k, c = kp.shape
    mid = 0.5 * (kp[:, :, None, :] + kp[:, None, :, :])   # [B, K, K, C]
    eye = torch.eye(k, dtype=kp.dtype, device=kp.device)[None, :, :, None]
    pam = (mid * (1 - eye) + kp[:, :, None, :] * eye).permute(0, 3, 1, 2)
    return torch.cat([pam, torch.full_like(pam, confidence)], dim=1)
