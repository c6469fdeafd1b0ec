"""HPE-Li baseline: selective-kernel CNN pose regressor.

Counterpart of ``wiflow_tpu/models/baselines/hpeli.py`` (ref
baseline/HPELI/hpeli.py:478-633, the ECCV'24 HPE-Li method on the WiFlow
dataset):

  [B, 540, 20] -> view [B, 3, 180, 20]
  SKUnit(3 -> 64)  -> AvgPool2d(2)     [B, 64, 90, 10]
  SKUnit(64 -> 128) -> AvgPool2d(2)    [B, 128, 45, 5]
  conv regression head ((3,1) strided convs) -> Flatten
  Linear(16*8*5 -> 30) -> [B, 15, 2]

``HPELiMMFi`` is the MM-Fi configuration (OriginalHPE, M=2; ref
cross_dataset_test/HPE-Li/model/HPE_no_denoiser.py:9-73).

Also the helpers the other baselines share, as in the JAX package:
:func:`conv2d` (XLA's padding rules on channel-last activations) and
:func:`flax_param` (a parameter drawn as flax's initializer draws it).

Layout: activations are channel-last ``[B, H, W, C]`` as in the JAX
package; a conv weight is a bare parameter in torch's ``[O, I, kH, kW]``,
named as the flax parameter is (``conv0_weight``), and a matrix used as
``x @ w`` keeps flax's ``[in, out]``.  ``models/baselines/convert.py``
carries flax variables across.  The dtypes follow the JAX module's: a
bias or a matrix of fp32 parameters added to a bf16 activation promotes
it to fp32, in torch as in JAX.  The convs and products are stock torch
ops: no TPU kernel backs them in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from wiflow_tpu_torch.core.config import resolve_device
from wiflow_tpu_torch.models.baselines.convert import FlaxLayout
from wiflow_tpu_torch.models.layers import TorchBatchNorm

Padding = Union[str, Sequence[Tuple[int, int]]]


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    if len(shape) < 2:
        return shape[0], shape[0]
    return shape[-2] * receptive, shape[-1] * receptive


def flax_param(shape: Sequence[int], init: str,
               generator: torch.Generator, device=None) -> nn.Parameter:
    """A parameter of flax ``shape`` drawn from ``generator`` (on the CPU)
    as flax's ``init`` draws it (``variance_scaling`` with flax's fans),
    in the port's layout: a 4-D HWIO kernel is returned as OIHW.

    ``init``: ``xavier_normal``, ``xavier_uniform``, ``he_normal``,
    ``lecun_normal`` (``nn.Dense``'s default), ``zeros`` or ``ones``."""
    shape = tuple(shape)
    if init in ("zeros", "ones"):
        w = (torch.zeros if init == "zeros" else torch.ones)(shape)
    else:
        fan_in, fan_out = _fans(shape)
        scale, fan, dist = {
            "xavier_normal": (1.0, (fan_in + fan_out) / 2, "normal"),
            "xavier_uniform": (1.0, (fan_in + fan_out) / 2, "uniform"),
            "he_normal": (2.0, fan_in, "normal"),
            "lecun_normal": (1.0, fan_in, "normal"),
        }[init]
        var = scale / fan
        w = torch.empty(shape)
        if dist == "uniform":
            lim = math.sqrt(3.0 * var)
            nn.init.uniform_(w, -lim, lim, generator=generator)
        else:
            # flax's truncated normal: std corrected for the cut at +-2
            std = math.sqrt(var) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
    if w.ndim == 4:
        w = w.permute(3, 2, 0, 1).contiguous()
    return nn.Parameter(w.to(resolve_device(device)))


def same_pads(size: int, k: int, stride: int, dilation: int
              ) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis: ``ceil(size / stride)``
    outputs, the odd pad after (a stride-2 3x3 conv on 120 pads (0, 1),
    where torch's ``padding=1`` would pad (1, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, *, stride=(1, 1),
           padding: Padding = "SAME", dilation=(1, 1),
           groups: int = 1) -> torch.Tensor:
    """The JAX package's ``conv2d`` on ``x [B, H, W, C]`` with an OIHW
    ``w``: ``padding`` is ``"SAME"`` (XLA's rule), ``"VALID"`` or explicit
    ``[(lo, hi), (lo, hi)]``.  The JAX conv runs at ``Precision.HIGHEST``:
    in fp32 on the card that means no TF32, which the entry points that
    run baselines turn off (``core/config.py::exact_fp32``).  ``b`` is
    added after the conv, so an fp32 bias promotes a bf16 output, as in
    JAX."""
    kh, kw = w.shape[-2:]
    if (kh, kw) == (1, 1) and padding in ("SAME", "VALID"):
        # a 1x1 conv pads nothing; its stride is taken as a slice (torch
        # 2.13's CPU backward of a strided 1x1 conv on a channel-last
        # input corrupts the heap, see ops/conv.py::conv1x1_2d)
        x, stride = x[:, ::stride[0], ::stride[1]], (1, 1)
    if padding == "SAME":
        pads = [same_pads(x.shape[1], kh, stride[0], dilation[0]),
                same_pads(x.shape[2], kw, stride[1], dilation[1])]
    elif padding == "VALID":
        pads = [(0, 0), (0, 0)]
    else:
        pads = padding
    xc = F.pad(x.movedim(-1, 1), (*pads[1], *pads[0]))
    y = F.conv2d(xc, w.to(x.dtype), stride=tuple(stride),
                 dilation=tuple(dilation), groups=groups).movedim(1, -1)
    return y if b is None else y + b


def matmul(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """``a @ w.astype(dtype)`` as ``jnp`` computes it: the weight rounded to
    ``dtype``, then both operands promoted to their common type (an fp32
    ``a`` keeps a bf16 model's product in fp32)."""
    w = w.to(dtype)
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.avg_pool(x, (2, 2), strides=(2, 2))`` (VALID) on
    ``[B, H, W, C]``."""
    return F.avg_pool2d(x.movedim(-1, 1), 2).movedim(1, -1)


class SKConv(nn.Module):
    """Selective-kernel conv (ref hpeli.py:478-537): ``m`` dilated 3x3
    branches, a time-pooled descriptor that keeps the frequency axis, an
    ``fc`` + BN over ``[B, H, d]``, and a softmax over the branches."""

    def __init__(self, cin: int, out_dim: int, m: int = 4, groups: int = 1,
                 r: int = 4, *, generator: torch.Generator, device=None):
        super().__init__()
        self.m, self.groups = m, groups
        d = max(out_dim // r, 32)
        for i in range(m):
            self.register_parameter(f"conv{i}_weight", flax_param(
                (3, 3, cin // groups, out_dim), "xavier_normal", generator,
                device))
            self.add_module(f"bn{i}", TorchBatchNorm(out_dim, device=device))
        self.fc_weight = flax_param((out_dim, d), "xavier_normal", generator,
                                    device)
        self.fc_bias = flax_param((d,), "zeros", generator, device)
        self.fc_bn = TorchBatchNorm(d, device=device)
        for i in range(m):
            self.register_parameter(f"att{i}_weight", flax_param(
                (d, out_dim), "xavier_normal", generator, device))
            self.register_parameter(f"att{i}_bias", flax_param(
                (out_dim,), "zeros", generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = []
        for i in range(self.m):
            y = conv2d(x, getattr(self, f"conv{i}_weight"),
                       padding=[(1 + i, 1 + i)] * 2, dilation=(1 + i, 1 + i),
                       groups=self.groups)
            feats.append(torch.relu(getattr(self, f"bn{i}")(y)))
        feats = torch.stack(feats, dim=1)             # [B, M, H, W, C]
        desc = feats.sum(dim=1).mean(dim=2)           # [B, H, C]
        z = matmul(desc, self.fc_weight, x.dtype)
        z = torch.relu(self.fc_bn(z + self.fc_bias))  # [B, H, d]
        att = torch.stack([matmul(z, getattr(self, f"att{i}_weight"), x.dtype)
                           + getattr(self, f"att{i}_bias")
                           for i in range(self.m)], dim=1)
        att = torch.softmax(att, dim=1)               # [B, M, H, C]
        return (feats * att[:, :, :, None, :]).sum(dim=1)


class SKUnit(nn.Module):
    """1x1 conv + BN + ReLU -> SKConv + BN + ReLU (ref hpeli.py:540-559)."""

    def __init__(self, cin: int, mid: int, out: int, m: int = 4,
                 groups: int = 1, r: int = 4, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.conv1_weight = flax_param((1, 1, cin, mid), "xavier_normal",
                                       generator, device)
        self.bn1 = TorchBatchNorm(mid, device=device)
        self.sk = SKConv(mid, out, m, groups, r, generator=generator,
                         device=device)
        self.bn2 = TorchBatchNorm(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(conv2d(x, self.conv1_weight)))
        return torch.relu(self.bn2(self.sk(y)))


class _HPELiBase(FlaxLayout, nn.Module):
    """Two SKUnits with 2x2 average pools, the (3,1) strided regression
    head and the linear layer; the two models differ in their input view
    and ``m``."""

    def __init__(self, in_hw: Tuple[int, int], cin: int, m: int,
                 num_keypoints: int, keypoint_dims: int, compute_dtype: str,
                 device, generator):
        super().__init__()
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.num_keypoints, self.keypoint_dims = num_keypoints, keypoint_dims
        self.compute_dtype = compute_dtype
        self.skunit1 = SKUnit(cin, 64, 64, m=m, generator=gen, device=dev)
        self.skunit2 = SKUnit(64, 128, 128, m=m, generator=gen, device=dev)
        h, w, c = in_hw[0] // 4, in_hw[1] // 4, 128
        self.heads = ((64, 2), (32, 2), (16, 1))
        for i, (cout, stride) in enumerate(self.heads):
            self.register_parameter(f"reg_conv{i}_weight", flax_param(
                (3, 1, c, cout), "xavier_normal", gen, dev))
            self.register_parameter(f"reg_conv{i}_bias", flax_param(
                (cout,), "zeros", gen, dev))
            h, c = (h - 3) // stride + 1, cout
        out = num_keypoints * keypoint_dims
        self.linear_weight = flax_param((c * h * w, out), "xavier_normal",
                                        gen, dev)
        self.linear_bias = flax_param((out,), "zeros", gen, dev)
        self.eval()

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = avg_pool2x2(self.skunit1(x))
        x = avg_pool2x2(self.skunit2(x))
        for i, (_, stride) in enumerate(self.heads):
            x = torch.relu(conv2d(x, getattr(self, f"reg_conv{i}_weight"),
                                  getattr(self, f"reg_conv{i}_bias"),
                                  stride=(stride, 1), padding="VALID"))
        x = x.permute(0, 3, 1, 2).reshape(b, -1)      # torch Flatten order
        x = matmul(x, self.linear_weight, x.dtype) + self.linear_bias
        return x.reshape(b, self.num_keypoints, self.keypoint_dims).float()


class HPELiNet(_HPELiBase):
    """HPE-Li on the WiFlow dataset (ref hpeli.py:562-633):
    ``[B, 540, 20]`` -> ``[B, 15, 2]``.  Built on ``device`` (CUDA unless
    ``"cpu"``) in eval mode, its parameters drawn from ``generator`` (a
    CPU ``torch.Generator``; seed 0 when None)."""

    def __init__(self, num_keypoints: int = 15, keypoint_dims: int = 2,
                 compute_dtype: str = "bfloat16", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__((180, 20), 3, 4, num_keypoints, keypoint_dims,
                         compute_dtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.to(getattr(torch, self.compute_dtype))
        # [B, 540, 20] -> [B, 3, 180, 20] -> channel-last [B, 180, 20, 3]
        return self._trunk(x.reshape(b, 3, 180, 20).permute(0, 2, 3, 1))


class HPELiMMFi(_HPELiBase):
    """OriginalHPE for MM-Fi (ref cross_dataset_test/HPE-Li/model/
    HPE_no_denoiser.py:9-73): ``[B, 3, 114, 10]`` -> ``[B, 17, 2]``, two
    SKUnits of M=2."""

    def __init__(self, num_keypoints: int = 17, keypoint_dims: int = 2,
                 compute_dtype: str = "bfloat16", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__((114, 10), 3, 2, num_keypoints, keypoint_dims,
                         compute_dtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(getattr(torch, self.compute_dtype))
        return self._trunk(x.permute(0, 2, 3, 1))     # [B, 114, 10, 3]
