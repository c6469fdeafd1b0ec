"""HPE-Li's model zoo, part 1: the attention variants, MultiAxisAttention,
the MLP regression head and the DSKNetTrans ablation model.

Counterpart of ``wiflow_tpu/models/baselines/sknet_trans.py`` (ref
cross_dataset_test/HPE-Li/model/):

  * utils/utils.py:5-118 — Self/ScaledDotProduct/MultiHead/Additive/
    GlobalContext attention (the DSKNetTrans ablation zoo),
  * utils/transformer_based_encoder.py:4-84 — MultiAxisAttention:
    channel-axis + frequency-axis transformer encoders, summed,
  * utils/regression.py:15-37 — 3-layer MLP head with BN,
  * sknet_trans_mmfi.py:156-252 / sknet_trans_wipose.py:156-251 —
    DSKNetTrans: 2 SKUnits + regression to 17x2 (MM-Fi) / 18x2 (WiPose).

Names and layout follow ``models/baselines/hpeli.py``: every parameter is
named as its flax path (``models/baselines/convert.py`` carries the JAX
variables across), activations are channel-last, a flax ``nn.Dense`` is
an ``nn.Linear`` whose fp32 weight promotes a bf16 input, as flax
promotes it.  The products and convolutions are stock torch ops: no TPU
kernel backs them in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wiflow_tpu_torch.core.config import resolve_device
from wiflow_tpu_torch.models.baselines.convert import FlaxLayout
from wiflow_tpu_torch.models.baselines.hpeli import (
    SKUnit, avg_pool2x2, conv2d, flax_param,
)
from wiflow_tpu_torch.models.baselines.performer import dense
from wiflow_tpu_torch.models.layers import TorchBatchNorm, TorchDropout


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense``: the input promoted to the weight's dtype."""
    return lin(x.to(torch.promote_types(x.dtype, lin.weight.dtype)))


def resize_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``jax.image.resize(x, (b, rows, t, c), "linear")`` on a channel-last
    ``x [B, F, T, C]``: the F axis resized with half-pixel centres, and
    antialiased as JAX's resize is by default, which matters only where it
    downsamples (torch's ``antialias=False`` there is off by whole units;
    ``models/baselines/wisppn.py::resize_bilinear`` therefore refuses to
    downsample).  Upsampling, the two agree with or without it."""
    b, f, t, c = x.shape
    y = F.interpolate(x.movedim(-1, 1), size=(rows, t), mode="bilinear",
                      align_corners=False, antialias=rows < f)
    return y.movedim(1, -1)


class SelfAttention(nn.Module):
    """Q/K/V linear + scaled dot-product over tokens (utils.py:5-25);
    ``scale_by_query=True`` is ScaledDotProductAttention (the two differ
    only in which tensor's width scales the logits)."""

    def __init__(self, input_dim: int, scale_by_query: bool = False, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.scale_by_query = scale_by_query
        for name in ("query", "key", "value"):
            self.add_module(name, dense(input_dim, input_dim, generator,
                                        device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k = linear(self.query, x), linear(self.key, x)
        v = linear(self.value, x)
        d = q.shape[-1] if self.scale_by_query else x.shape[-1]
        scores = q @ k.transpose(-1, -2) / math.sqrt(d)
        return torch.softmax(scores, dim=-1) @ v


class MultiHeadAttention(nn.Module):
    """utils.py:49-73."""

    def __init__(self, input_dim: int, num_heads: int = 4, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.input_dim, self.num_heads = input_dim, num_heads
        for name in ("query", "key", "value", "fc_out"):
            self.add_module(name, dense(input_dim, input_dim, generator,
                                        device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        hd = self.input_dim // self.num_heads

        def split(lin):
            return linear(lin, x).reshape(b, -1, self.num_heads,
                                          hd).transpose(1, 2)

        q, k, v = split(self.query), split(self.key), split(self.value)
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
        out = torch.softmax(scores, dim=-1) @ v
        out = out.transpose(1, 2).reshape(b, -1, self.input_dim)
        return linear(self.fc_out, out)


class AdditiveAttention(nn.Module):
    """utils.py:75-96: ``tanh(Q K^T) v`` scores over tokens (``v`` has
    ``input_dim`` entries, one a token: the reference's shapes need as many
    tokens as features)."""

    def __init__(self, input_dim: int, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.query = dense(input_dim, input_dim, generator, device)
        self.key = dense(input_dim, input_dim, generator, device)
        v = torch.rand((input_dim,), generator=generator)   # U[0, 1)
        self.v = nn.Parameter(v.to(resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k = linear(self.query, x), linear(self.key, x)
        scores = torch.tanh(q @ k.transpose(-1, -2)) @ self.v.to(q.dtype)
        w = torch.softmax(scores, dim=-1)
        return (w.unsqueeze(-1) * x).sum(dim=-2, keepdim=True) * \
            torch.ones_like(x)


class GlobalContextAttention(nn.Module):
    """utils.py:98-118: unscaled dot-product attention."""

    def __init__(self, input_dim: int, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        for name in ("query", "key", "value"):
            self.add_module(name, dense(input_dim, input_dim, generator,
                                        device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k = linear(self.query, x), linear(self.key, x)
        scores = q @ k.transpose(-1, -2)
        return torch.softmax(scores, dim=-1) @ linear(self.value, x)


class TransformerEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (post-norm), with flax's
    LayerNorm (eps 1e-6)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1,
                 dropout_generator: torch.Generator | None = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            generator=generator,
                                            device=device)
        self.drop1 = TorchDropout(dropout, dropout_generator)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6, device=device)
        self.linear1 = dense(d_model, dim_feedforward, generator, device)
        self.drop_ff = TorchDropout(dropout, dropout_generator)
        self.linear2 = dense(dim_feedforward, d_model, generator, device)
        self.drop2 = TorchDropout(dropout, dropout_generator)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.drop1(self.self_attn(x)))
        y = self.drop_ff(torch.relu(linear(self.linear1, x)))
        return self.norm2(x + self.drop2(linear(self.linear2, y)))


class MultiAxisAttention(nn.Module):
    """Channel-axis + frequency-axis transformer encoders, summed
    (transformer_based_encoder.py:4-84), on channel-last ``[B, F, T, C]``;
    the output's F axis is resized to ``embed_dim // reduction_factor``
    rows (:func:`resize_rows`)."""

    def __init__(self, in_channels: int, embed_dim: int, num_heads: int = 4,
                 depth: int = 2, dim_feedforward: int = 256,
                 reduction_factor: int = 2, dropout: float = 0.1,
                 dropout_generator: torch.Generator | None = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim, self.depth = embed_dim, depth
        self.reduction_factor = reduction_factor
        self.expand_weight = flax_param((1, 1, in_channels, embed_dim),
                                        "he_normal", generator, dev)
        self.expand_bn = TorchBatchNorm(embed_dim, device=dev)
        for axis in ("channel", "freq"):
            for i in range(depth):
                self.add_module(f"{axis}_att_{i}", TransformerEncoderLayer(
                    embed_dim, num_heads, dim_feedforward, dropout,
                    dropout_generator, generator=generator, device=dev))
        self.reduce_weight = flax_param((3, 1, embed_dim, embed_dim),
                                        "he_normal", generator, dev)
        self.reduce_bn = TorchBatchNorm(embed_dim, device=dev)
        self.fc = dense(embed_dim, embed_dim, generator, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, t, _ = x.shape
        e = self.embed_dim
        x = torch.relu(self.expand_bn(conv2d(x, self.expand_weight)))
        xc = x.reshape(b, f * t, e)                 # tokens: (f, t)
        for i in range(self.depth):
            xc = getattr(self, f"channel_att_{i}")(xc)
        xc = xc.reshape(b, f, t, e)
        xf = x.transpose(1, 2).reshape(b * t, f, e)  # tokens: frequency bins
        for i in range(self.depth):
            xf = getattr(self, f"freq_att_{i}")(xf)
        xf = xf.reshape(b, t, f, e).transpose(1, 2)
        out = conv2d(xc + xf, self.reduce_weight)
        out = torch.relu(self.reduce_bn(out))
        out = resize_rows(out, e // self.reduction_factor)
        return linear(self.fc, out)


class RegressionHead(nn.Module):
    """3-layer MLP with BN and dropout (regression.py:15-37) over the
    flattened ``[B, in_features]`` input; its names (``fc1``, ``fc2``,
    ``fc3``, ``bn``) are the reference's and flax's both."""

    def __init__(self, in_features: int, output_dim: int,
                 hidden_dim: int = 32,
                 dropout_generator: torch.Generator | None = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.fc1 = dense(in_features, hidden_dim, generator, device)
        self.drop1 = TorchDropout(0.1, dropout_generator)
        self.fc2 = dense(hidden_dim, hidden_dim * 2, generator, device)
        self.bn = TorchBatchNorm(hidden_dim * 2, device=device)
        self.drop2 = TorchDropout(0.1, dropout_generator)
        self.fc3 = dense(hidden_dim * 2, output_dim, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = self.drop1(torch.relu(linear(self.fc1, x)))
        x = self.drop2(torch.relu(self.bn(linear(self.fc2, x))))
        return linear(self.fc3, x)


class DSKNetTrans(FlaxLayout, nn.Module):
    """SKUnit x2 + regression (sknet_trans_mmfi.py:156-252): MM-Fi
    ``in_shape=(3, 114, 10)`` -> ``[B, 17, 2]``; WiPose ``(9, 30, 5)``,
    ``num_keypoints=18`` (sknet_trans_wipose.py:156-251).  Built on
    ``device`` (CUDA unless ``"cpu"``) in eval mode, its parameters drawn
    from ``generator`` (a CPU ``torch.Generator``; seed 0 when None), its
    dropout masks from ``dropout_generator`` on the device."""

    def __init__(self, num_keypoints: int = 17, keypoint_dims: int = 2,
                 num_lay: int = 128, hidden_reg: int = 32, branches: int = 3,
                 compute_dtype: str = "bfloat16",
                 in_shape: Sequence[int] = (3, 114, 10), *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.num_keypoints, self.keypoint_dims = num_keypoints, keypoint_dims
        self.compute_dtype = compute_dtype
        self.dropout_generator = torch.Generator(device=dev)
        cin, h, w = in_shape
        self.skunit1 = SKUnit(cin, num_lay, num_lay, m=branches,
                              generator=gen, device=dev)
        self.norm = TorchBatchNorm(num_lay, device=dev)
        self.skunit2 = SKUnit(num_lay, num_lay * 2, num_lay * 2, m=branches,
                              generator=gen, device=dev)
        self.regression = RegressionHead(
            num_lay * 2 * (h // 2) * (w // 2), num_keypoints * keypoint_dims,
            hidden_reg, self.dropout_generator, generator=gen, device=dev)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.to(getattr(torch, self.compute_dtype)).permute(0, 2, 3, 1)
        x = self.skunit2(self.norm(self.skunit1(x)))
        x = avg_pool2x2(x).permute(0, 3, 1, 2)       # NCHW flatten order
        out = self.regression(x)
        return out.reshape(b, self.num_keypoints, self.keypoint_dims).float()
