"""WiFlow pose model, as ``nn.Module``s, in train and eval mode.

Counterpart of ``wiflow_tpu/models/wiflow.py::WiFlowPoseModel``:
``[B, 540, 20]`` CSI windows -> ``[B, 15, 2]`` keypoints through the
grouped dilated TCN, the (1,3) conv stack, dual axial attention and the
conv decoder.  Parameter and buffer names are the reference torch
``state_dict`` names (``models/torch_compat.py``), so JAX exports and
reference checkpoints load by name; dropout holds no parameters, so the
train and eval modules have the same ``state_dict``.

In eval mode every step is a stock torch op: this is the plain reference
of the serving path, which goes through ``models/fast.py::fast_forward``.
In train mode (``model.train()``) BatchNorm uses batch statistics and
updates its running ones, dropout is on, and the attention core and the
batch moments of its logits run through the train kernels of
``ops/kernels/axial_attention_train.py`` (their plain versions on a CPU
tensor).  Dropout draws from ``WiFlowPoseModel.dropout_generator``.

With ``ModelConfig.tcn_train_impl`` / ``conv_train_impl`` set to
``"fused"`` (or ``"auto"`` on a CUDA device) the train-mode TCN and conv
stack run through ``ops/kernels/stage_fused.py``: one ``stage`` per
BN-apply -> SiLU -> dropout -> conv, which also sums the next BN's
moments, and one ``join`` per residual tail.  The parameters, buffers,
dropout draws and values are those of the stock-op path; eval mode
ignores the switches.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from wiflow_tpu_torch.core.config import (
    ModelConfig, resolve_device, use_fused,
)
from wiflow_tpu_torch.models.layers import (
    TorchBatchNorm, TorchDropout, TorchDropout2d, silu,
)
from wiflow_tpu_torch.ops.conv import (
    causal_grouped_conv1d, conv1x1_2d, conv1xk_w, conv3x3_2d,
    pointwise_conv1d,
)
from wiflow_tpu_torch.ops.kernels.axial_attention_train import (
    axial_core, logits_moments_fused,
)
from wiflow_tpu_torch.ops.kernels.stage_fused import join, stage
from wiflow_tpu_torch.ops.norm import EPS


class TCNLevel(nn.Module):
    """One dilated grouped temporal block (ref models/tcn.py:14-74)."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int,
                 dilation: int, groups: int, dropout: float = 0.0,
                 generator: torch.Generator | None = None, *, device=None,
                 fused: bool = False):
        super().__init__()
        if fused and kernel_size != 3:
            raise ValueError(f"the fused train path takes tcn_kernel_size 3, "
                             f"got {kernel_size}")
        self.dilation, self.groups, self.fused = dilation, groups, fused
        k = kernel_size
        self.conv1_group = nn.Conv1d(n_in, n_in, k, groups=groups,
                                     bias=False, device=device)
        self.bn1_group = TorchBatchNorm(n_in, device=device)
        self.conv1_pw = nn.Conv1d(n_in, n_out, 1, bias=False, device=device)
        self.bn1_pw = TorchBatchNorm(n_out, device=device)
        self.conv2_group = nn.Conv1d(n_out, n_out, k, groups=groups,
                                     bias=False, device=device)
        self.bn2_group = TorchBatchNorm(n_out, device=device)
        self.conv2_pw = nn.Conv1d(n_out, n_out, 1, bias=False, device=device)
        self.bn2_pw = TorchBatchNorm(n_out, device=device)
        self.dropout1 = TorchDropout(dropout, generator)
        self.dropout2 = TorchDropout(dropout, generator)
        self.downsample = None
        if n_in != n_out:
            self.downsample = nn.Sequential(
                nn.Conv1d(n_in, n_out, 1, bias=False, device=device),
                TorchBatchNorm(n_out, device=device))

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode through four or five stages and a join
        (``wiflow_tpu/models/wiflow.py::TCNLevel._fused_blocks``)."""
        n = x.shape[0] * x.shape[1]                  # BN count: B * T
        keep = 1.0 - self.dropout1.rate
        dil = self.dilation
        res_v = ()
        res = x
        if self.downsample is not None:
            res, s = stage(x, None, None, None, None,
                           self.downsample[0].weight, None, kind="identity")
            res_v = self.downsample[1].from_sums(s, n)
        h, s = stage(x, None, None, None, None, self.conv1_group.weight,
                     None, kind="causal3", dil=dil)
        h, s = stage(h, *self.bn1_group.from_sums(s, n), None,
                     self.conv1_pw.weight, None, kind="identity")
        v = self.bn1_pw.from_sums(s, n)
        h, s = stage(h, *v, self.dropout1.keep_mask(h),
                     self.conv2_group.weight, None, kind="causal3", dil=dil,
                     keep=keep)
        h, s = stage(h, *self.bn2_group.from_sums(s, n), None,
                     self.conv2_pw.weight, None, kind="identity")
        v = self.bn2_pw.from_sums(s, n)
        return join(h, *v, self.dropout2.keep_mask(h), res, *res_v,
                    keep=keep, act_h=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, T, C_in]`` -> ``[B, T, C_out]``."""
        if self.fused and self.training:
            return self._forward_fused(x)
        if self.downsample is not None:
            res = self.downsample[1](
                pointwise_conv1d(x, self.downsample[0].weight))
        else:
            res = x
        out = causal_grouped_conv1d(x, self.conv1_group.weight,
                                    dilation=self.dilation, groups=self.groups)
        out = silu(self.bn1_group(out))
        out = self.dropout1(silu(self.bn1_pw(
            pointwise_conv1d(out, self.conv1_pw.weight))))
        out = causal_grouped_conv1d(out, self.conv2_group.weight,
                                    dilation=self.dilation, groups=self.groups)
        out = silu(self.bn2_group(out))
        out = self.dropout2(silu(self.bn2_pw(
            pointwise_conv1d(out, self.conv2_pw.weight))))
        return silu(out + res)


class TCNStack(nn.Module):
    """Levels with dilation ``2**i`` (ref models/tcn.py:76-97)."""

    def __init__(self, num_inputs: int, num_channels, kernel_size: int,
                 groups: int, dropout: float = 0.0,
                 generator: torch.Generator | None = None, *, device=None,
                 train_impl: str = "xla"):
        super().__init__()
        fused = use_fused(train_impl, torch.device(device or "cpu"))
        levels, n_in = [], num_inputs
        for i, n_out in enumerate(num_channels):
            levels.append(TCNLevel(n_in, n_out, kernel_size, 2 ** i, groups,
                                   dropout, generator, device=device,
                                   fused=fused))
            n_in = n_out
        self.network = nn.Sequential(*levels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.network(x)


class ConvBlock(nn.Module):
    """(1,3) residual block over W (ref models/convnet.py:4-74).

    ``stride_w=2`` is the reference's ``AsymmetricConvBlock``,
    ``stride_w=1`` its ``ConvBlock1``.  ``block`` keeps the reference's
    ``nn.Sequential`` indices (conv 0/4/8, BN 1/5/9); the SiLU and
    Dropout2d slots between them (2/6 and 3/7) hold no parameters.
    """

    def __init__(self, n_in: int, n_out: int, stride_w: int = 1,
                 dropout: float = 0.0,
                 generator: torch.Generator | None = None, *, device=None,
                 fused: bool = False):
        super().__init__()
        if fused and stride_w not in (1, 2):
            raise ValueError(f"the fused train path takes stride 1 or 2, "
                             f"got {stride_w}")
        self.stride_w, self.fused = stride_w, fused

        def conv(ci):
            return nn.Conv2d(ci, n_out, (1, 3), stride=(1, 1),
                             padding=(0, 1), device=device)

        self.block = nn.Sequential(
            conv(n_in), TorchBatchNorm(n_out, device=device), nn.SiLU(),
            TorchDropout2d(dropout, generator),
            conv(n_out), TorchBatchNorm(n_out, device=device), nn.SiLU(),
            TorchDropout2d(dropout, generator),
            conv(n_out), TorchBatchNorm(n_out, device=device))
        self.downsample = nn.Sequential(
            nn.Conv2d(n_in, n_out, 1, bias=False, device=device),
            TorchBatchNorm(n_out, device=device))

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode through four stages and a join
        (``wiflow_tpu/models/wiflow.py::ConvBlock._fused_stage``)."""
        blk = self.block
        strided = self.stride_w == 2
        keep = 1.0 - blk[3].rate
        res, s = stage(x, None, None, None, None, self.downsample[0].weight,
                       None, kind="chunk1" if strided else "identity")
        n = res.numel() // res.shape[-1]             # BN count: B * H * W_out
        res_v = self.downsample[1].from_sums(s, n)
        h, s = stage(x, None, None, None, None, blk[0].weight, blk[0].bias,
                     kind="chunk3" if strided else "sym3")
        for i in (4, 8):
            v = blk[i - 3].from_sums(s, n)
            h, s = stage(h, *v, blk[i - 1].keep_mask(h), blk[i].weight,
                         blk[i].bias, kind="sym3", keep=keep)
        return join(h, *blk[9].from_sums(s, n), None, res, *res_v,
                    act_h=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, H, W, C_in]`` -> ``[B, H, W_out, C_out]``."""
        if self.fused and self.training:
            return self._forward_fused(x)
        identity = self.downsample[1](conv1x1_2d(
            x, self.downsample[0].weight, stride_w=self.stride_w))
        out = x
        for i, stride in ((0, self.stride_w), (4, 1), (8, 1)):
            c = self.block[i]
            out = self.block[i + 1](conv1xk_w(out, c.weight, c.bias,
                                              stride=stride))
            if i < 8:
                out = self.block[i + 3](silu(out))
        return silu(out + identity)


class AxialAttention(nn.Module):
    """Grouped single-axis attention with BN on the logits
    (ref models/attention.py:7-80).

    Input is channel-last ``[B, H, W, C]``; ``width=True`` attends along W.
    The logits BN's mean and bias are constant along the softmax axis and
    cancel, so only its scale ``gamma / sqrt(var + eps)`` is applied
    (``wiflow_tpu/models/wiflow.py::LogitsBNScale``).  In train mode the
    variance is the batch's, from the sums of the logits and their squares
    (no logits in memory); ``bn_similarity``'s running statistics move with
    the unbiased variance over ``count = n * L * L`` logits per group, and
    its bias, which cancels, gets no gradient.
    """

    def __init__(self, planes: int, groups: int, width: bool, *,
                 device=None):
        super().__init__()
        self.planes, self.groups, self.width = planes, groups, width
        self.qkv_transform = nn.Conv1d(planes, planes * 3, 1, bias=False,
                                       device=device)
        self.bn_qkv = TorchBatchNorm(planes * 3, device=device)
        self.bn_similarity = TorchBatchNorm(groups, device=device)
        self.bn_output = TorchBatchNorm(planes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if self.width:
            xr = x.reshape(b * h, w, c)
        else:
            xr = x.transpose(1, 2).reshape(b * w, h, c)
        n, length, _ = xr.shape
        g, gp = self.groups, self.planes // self.groups
        qkv = self.bn_qkv(pointwise_conv1d(xr, self.qkv_transform.weight))
        bns = self.bn_similarity
        if self.training:
            q, k, v = torch.split(qkv, self.planes, dim=-1)
            count = n * length * length
            mean, var = logits_moments_fused(q, k, g, count)
            bns.track(mean.detach(), var.detach(), count)
            scale = bns.weight.float() * torch.rsqrt(var + EPS)
            out = axial_core(q, k, v, scale)
        else:
            q, k, v = (t.reshape(n, length, g, gp)
                       for t in torch.split(qkv, self.planes, dim=-1))
            scale = bns.weight.float() * torch.rsqrt(
                bns.running_var.float() + EPS)
            logits = torch.einsum("bigc,bjgc->bgij", q.float(), k.float())
            sim = torch.softmax(logits * scale[None, :, None, None], dim=-1)
            out = torch.einsum("bgij,bjgc->bigc", sim.to(x.dtype).float(),
                               v.float()).to(x.dtype)
        out = self.bn_output(out.reshape(n, length, self.planes))
        if self.width:
            return out.reshape(b, h, w, self.planes)
        return out.reshape(b, w, h, self.planes).transpose(1, 2)


class DualAxialAttention(nn.Module):
    """Width-axis then height-axis attention (ref attention.py:83-98)."""

    def __init__(self, planes: int, groups: int = 8, *, device=None):
        super().__init__()
        self.width_axis = AxialAttention(planes, groups, True, device=device)
        self.height_axis = AxialAttention(planes, groups, False,
                                          device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.height_axis(self.width_axis(x))


class WiFlowPoseModel(nn.Module):
    """Full WiFlow encoder-decoder (ref models/pose_model.py:9-97).

    Built on ``device`` (CUDA unless ``device="cpu"``) in eval mode, with
    parameters drawn from ``generator`` (a CPU ``torch.Generator``; the
    reference's init: kaiming-normal fan-out for Conv1d, torch's default
    uniform for Conv2d, BN at identity).  ``dropout_generator``, on the
    model's device, draws every dropout mask in train mode; seed it
    (``manual_seed``) to fix them.
    """

    def __init__(self, config: ModelConfig = ModelConfig(), *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = self.config = config
        dev = resolve_device(device)
        gen = self.dropout_generator = torch.Generator(device=dev)
        self.tcn = TCNStack(cfg.num_subcarriers, tuple(cfg.tcn_channels),
                            cfg.tcn_kernel_size, cfg.tcn_groups, cfg.dropout,
                            gen, device=dev, train_impl=cfg.tcn_train_impl)
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
        self.attention = DualAxialAttention(c, cfg.attention_groups,
                                            device=dev)
        self.decoder = nn.Sequential(
            nn.Conv2d(c, 32, 3, padding=1, device=dev),
            TorchBatchNorm(32, device=dev), nn.SiLU(),
            nn.Conv2d(32, cfg.keypoint_dims, 1, device=dev),
            TorchBatchNorm(cfg.keypoint_dims, device=dev), nn.SiLU())
        self.reset_parameters(generator)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        gen = generator or torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                fan_out = m.out_channels * m.kernel_size[0]
                w = torch.randn(m.weight.shape, generator=gen)
                m.weight.copy_(w * math.sqrt(2.0 / fan_out))
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                bound = math.sqrt(1.0 / fan_in)
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen)
                               * 2 * bound - bound)
                if m.bias is not None:
                    m.bias.copy_(torch.rand(m.bias.shape, generator=gen)
                                 * 2 * bound - bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if x.ndim != 3 or tuple(x.shape[1:]) != (cfg.num_subcarriers,
                                                 cfg.window_size):
            raise ValueError(
                f"WiFlowPoseModel expects [B, {cfg.num_subcarriers}, "
                f"{cfg.window_size}] CSI windows, got {tuple(x.shape)}")
        x = x.to(cfg.dtype).transpose(1, 2)               # [B, T, C]
        if self.training and self.tcn.network[0].fused:
            x = x.contiguous()        # once, for the stages that read it
        x = self.tcn(x)[..., None]                        # [B, T, 240, 1]
        x = self.up(x)
        for blk in self.residual_blocks:
            x = blk(x)                                    # [B, T, 15, C]
        x = self.attention(x.transpose(1, 2))             # [B, 15, T, C]
        d = self.decoder
        x = silu(d[1](conv3x3_2d(x, d[0].weight, d[0].bias)))
        x = silu(d[4](conv1x1_2d(x, d[3].weight, d[3].bias)))
        return x.float().mean(dim=2)                      # [B, 15, 2]
