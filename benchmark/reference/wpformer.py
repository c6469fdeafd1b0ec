"""Reference of WPformer, Setting 1 (``baseline/WPformer/model.py:281-452``
and ``ChannelTrans.py:24-291`` of the WiFlow repository): ``[B, 540, 20]``
CSI windows to ``[B, 15, 2]`` keypoints.

Plain float32 layers over a ``state_dict``, NCHW as the published model
runs them:

* the 540 subcarriers cut into 18 streams of 30, each a one-channel image
  resized bilinearly (half-pixel centres) to 60 x 32;
* one ResNet34 trunk for every stream: a 3x3 stem to 64 channels (no
  max-pool) and layers 1-3 at 64/128/256 of 3/4/6 basic blocks;
* the streams side by side along the width, ``[B, 256, 15, 144]``, a
  BatchNorm;
* the channel transformer over its 2,160 tokens: learned position
  embeddings, then per layer a pre-LayerNorm channel attention (each of 3
  heads forms ``Q^T K / sqrt(C)``, a ``[C, C]`` map over all tokens,
  InstanceNorm-ed as a whole, row softmax, ``P V^T``; the heads'
  contexts averaged, then the output projection) and a pre-LayerNorm GELU
  MLP (256 -> 1024 -> 256), both residual; a last LayerNorm; the
  reconstruction (1x1 conv with bias, BatchNorm, ReLU) plus the
  transformer's input;
* a 3x3 conv to 32, BatchNorm, ReLU, a 1x1 conv to the keypoint dims,
  BatchNorm, ReLU, the mean over the width, a BatchNorm1d.

Where it departs from the published code, it follows the port
(``wiflow_tpu_torch/models/baselines/wpformer.py``), which follows the JAX
package: LayerNorm's eps is flax's 1e-6 (``layer_norm_eps``), GELU is the
tanh form (``gelu``), the embeddings add no patch convolution, and
dropout is left out (eval).  Names: the trunk's are torchvision's
ResNet34 names (which the published model's ImageNet warm start loads),
the transformer's those of the published channel transformer
(``embeddings_1``, ``encoder.layer.{l}.channel_attn.query1.{h}``, ...,
``reconstruct_1``); the BatchNorm before the transformer (``pre_bn``),
the decoder (``decoder.{0,1,3,4}``) and the pooled BatchNorm1d
(``pool_bn``) are named here.

In eval mode the forward takes at most ``BLOCK`` rows at once (a serving
batch of 4,096 would hold over 36 GB in one trunk activation); in train
mode it takes the batch whole, so that each BatchNorm's statistics are of
the whole batch (``benchmark/weights.py`` calibrates with 512 rows).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from benchmark import channel_attention_work as caw
from benchmark.reference.model import Run, Tensor, bn_spec

BLOCK = 128
STEM = 64                 # the stem's width (ResNet34's)
INSTANCE_EPS = 1e-5       # InstanceNorm2d's


def input_shape(cfg: Mapping) -> tuple:
    return (cfg["num_subcarriers"], cfg["window_size"])


def trunk_blocks(cfg: Mapping):
    """(prefix, c_in, c_out, stride) of every basic block."""
    out, c = [], STEM
    for li, (width, n) in enumerate(zip(cfg["trunk_widths"],
                                        cfg["trunk_blocks"])):
        for bi in range(n):
            out.append((f"layer{li + 1}.{bi}", c, width,
                        2 if li > 0 and bi == 0 else 1))
            c = width
    return out


def spec(cfg: Mapping):
    n, c, heads = caw.tokens_channels_heads(cfg)
    d, mlp = cfg["keypoint_dims"], cfg["mlp_dim"]
    out = [("conv1.weight", (STEM, 1, 3, 3), "conv2d")] + bn_spec("bn1", STEM)
    for p, ci, co, stride in trunk_blocks(cfg):
        out += [(f"{p}.conv1.weight", (co, ci, 3, 3), "conv2d")]
        out += bn_spec(f"{p}.bn1", co)
        out += [(f"{p}.conv2.weight", (co, co, 3, 3), "conv2d")]
        out += bn_spec(f"{p}.bn2", co)
        if stride != 1 or ci != co:
            out += [(f"{p}.downsample.0.weight", (co, ci, 1, 1), "conv2d")]
            out += bn_spec(f"{p}.downsample.1", co)
    out += bn_spec("pre_bn", c)
    out += [("tf.embeddings_1.position_embeddings", (1, n, c), "conv2d")]
    for i in range(cfg["num_layers"]):
        p = f"tf.encoder.layer.{i}"
        out += [(f"{p}.attn_norm1.weight", (c,), "bn_weight"),
                (f"{p}.attn_norm1.bias", (c,), "bn_bias")]
        for name in ("query1", "key", "value"):
            out += [(f"{p}.channel_attn.{name}.{h}.weight", (c, c), "conv2d")
                    for h in range(heads)]
        out += [(f"{p}.channel_attn.out1.weight", (c, c), "conv2d"),
                (f"{p}.ffn_norm1.weight", (c,), "bn_weight"),
                (f"{p}.ffn_norm1.bias", (c,), "bn_bias"),
                (f"{p}.ffn1.fc1.weight", (mlp, c), "conv2d"),
                (f"{p}.ffn1.fc1.bias", (mlp,), "conv2d_bias"),
                (f"{p}.ffn1.fc2.weight", (c, mlp), "conv2d"),
                (f"{p}.ffn1.fc2.bias", (c,), "conv2d_bias")]
    out += [("tf.encoder.encoder_norm1.weight", (c,), "bn_weight"),
            ("tf.encoder.encoder_norm1.bias", (c,), "bn_bias"),
            ("tf.reconstruct_1.conv.weight", (c, c, 1, 1), "conv2d"),
            ("tf.reconstruct_1.conv.bias", (c,), "conv2d_bias")]
    out += bn_spec("tf.reconstruct_1.norm", c)
    out += [("decoder.0.weight", (32, c, 3, 3), "conv2d")]
    out += bn_spec("decoder.1", 32)
    out += [("decoder.3.weight", (d, 32, 1, 1), "conv2d")]
    out += bn_spec("decoder.4", d)
    out += bn_spec("pool_bn", d)
    return out


def conv(r: Run, x: Tensor, name: str, *, stride: int = 1, padding: int = 0,
         bias: bool = False) -> Tensor:
    b = r.w(name.replace(".weight", ".bias")) if bias else None
    return r.q(F.conv2d(x, r.w(name), b, stride=stride, padding=padding))


def relu(r: Run, x: Tensor) -> Tensor:
    return r.q(torch.relu(x))


def trunk(r: Run, x: Tensor, cfg: Mapping) -> Tensor:
    """The ResNet34 stem and layers on ``[B, 1, H, W]``."""
    x = relu(r, r.bn(conv(r, x, "conv1.weight", padding=1), "bn1", axis=1))
    for p, ci, co, stride in trunk_blocks(cfg):
        h = relu(r, r.bn(conv(r, x, f"{p}.conv1.weight", stride=stride,
                              padding=1), f"{p}.bn1", axis=1))
        h = r.bn(conv(r, h, f"{p}.conv2.weight", padding=1), f"{p}.bn2",
                 axis=1)
        if stride != 1 or ci != co:
            x = r.bn(conv(r, x, f"{p}.downsample.0.weight", stride=stride),
                     f"{p}.downsample.1", axis=1)
        x = relu(r, h + x)
    return x


def layer_norm(r: Run, x: Tensor, prefix: str, cfg: Mapping) -> Tensor:
    return r.q(F.layer_norm(x, x.shape[-1:], r.w(f"{prefix}.weight"),
                            r.w(f"{prefix}.bias"), cfg["layer_norm_eps"]))


def linear(r: Run, x: Tensor, prefix: str, bias: bool = True) -> Tensor:
    b = r.w(f"{prefix}.bias") if bias else None
    return r.q(F.linear(x, r.w(f"{prefix}.weight"), b))


def channel_attention(r: Run, x: Tensor, prefix: str, heads: int) -> Tensor:
    """``Attention_org`` on tokens ``[B, N, C]``: per head the ``[C, C]``
    scores over all tokens, InstanceNorm over the whole map, row softmax,
    the context; the heads' mean, then ``out1``."""
    c = x.shape[-1]

    def stack(name):
        return torch.stack([linear(r, x, f"{prefix}.{name}.{h}", bias=False)
                            for h in range(heads)], dim=1)   # [B, H, N, C]

    q, k, v = stack("query1"), stack("key"), stack("value")
    s = r.q(q.transpose(-1, -2) @ k / math.sqrt(c))          # [B, H, C, C]
    mean = s.mean(dim=(-2, -1), keepdim=True)
    var = s.var(dim=(-2, -1), unbiased=False, keepdim=True)
    z = r.q((s - mean) / torch.sqrt(var + INSTANCE_EPS))
    p = r.q(torch.softmax(z, dim=-1))
    ctx = r.q(p @ v.transpose(-1, -2))                       # [B, H, C, N]
    ctx = r.q(ctx.permute(0, 3, 2, 1).mean(dim=3))           # [B, N, C]
    return linear(r, ctx, f"{prefix}.out1", bias=False)


def gelu(r: Run, x: Tensor, cfg: Mapping) -> Tensor:
    return r.q(F.gelu(x, approximate=cfg["gelu"]))


def channel_transformer(r: Run, x: Tensor, cfg: Mapping) -> Tensor:
    """``ChannelTransformer`` on ``[B, C, H, W]``, its residual included."""
    b, c, h, w = x.shape
    heads = cfg["heads"]
    t = r.q(x.flatten(2).transpose(1, 2)
            + r.w("tf.embeddings_1.position_embeddings"))
    for i in range(cfg["num_layers"]):
        p = f"tf.encoder.layer.{i}"
        y = layer_norm(r, t, f"{p}.attn_norm1", cfg)
        t = r.q(t + channel_attention(r, y, f"{p}.channel_attn", heads))
        y = layer_norm(r, t, f"{p}.ffn_norm1", cfg)
        y = gelu(r, linear(r, y, f"{p}.ffn1.fc1"), cfg)
        t = r.q(t + linear(r, y, f"{p}.ffn1.fc2"))
    t = layer_norm(r, t, "tf.encoder.encoder_norm1", cfg)
    y = t.transpose(1, 2).reshape(b, c, h, w)
    y = relu(r, r.bn(conv(r, y, "tf.reconstruct_1.conv.weight", bias=True),
                     "tf.reconstruct_1.norm", axis=1))
    return r.q(y + x)


def forward(r: Run, x: Tensor, cfg: Mapping) -> Tensor:
    if not r.train and x.shape[0] > BLOCK:
        return torch.cat([forward(r, x[i:i + BLOCK], cfg)
                          for i in range(0, x.shape[0], BLOCK)])
    b, s = x.shape[0], cfg["num_chunks"]
    x = r.q(x.float())
    x = x.reshape(b * s, 1, x.shape[1] // s, x.shape[2])
    x = r.q(F.interpolate(x, size=tuple(cfg["resize_to"]), mode="bilinear",
                          align_corners=False))
    x = trunk(r, x, cfg)                                  # [B S, C, h, w]
    _, c, fh, fw = x.shape
    x = x.reshape(b, s, c, fh, fw).permute(0, 2, 3, 1, 4)
    x = r.bn(x.reshape(b, c, fh, s * fw), "pre_bn", axis=1)   # streams on W
    x = channel_transformer(r, x, cfg)
    y = relu(r, r.bn(conv(r, x, "decoder.0.weight", padding=1), "decoder.1",
                     axis=1))
    y = relu(r, r.bn(conv(r, y, "decoder.3.weight"), "decoder.4", axis=1))
    y = r.bn(r.q(y.mean(dim=3)), "pool_bn", axis=1)       # [B, D, K]
    return y.transpose(1, 2)


def forward_flops(cfg: Mapping) -> float:
    """Every product of one window: the trunk's convolutions over its 18
    streams, the transformer's projections, scores, contexts, MLP and
    reconstruction, the decoder's convolutions (about 71.5 GFLOP)."""
    h, w = cfg["resize_to"]
    macs = h * w * STEM * 9
    for _, ci, co, stride in trunk_blocks(cfg):
        h, w = (h - 1) // stride + 1, (w - 1) // stride + 1
        macs += h * w * co * 9 * (ci + co)
        if stride != 1 or ci != co:
            macs += h * w * co * ci
    macs *= cfg["num_chunks"]
    n, c, heads = caw.tokens_channels_heads(cfg)
    per_layer = (n * c * 3 * heads * c            # Q, K, V
                 + 2 * heads * c * c * n          # scores, context
                 + n * c * c                      # out1
                 + 2 * n * c * cfg["mlp_dim"])    # MLP
    macs += cfg["num_layers"] * per_layer + n * c * c        # reconstruction
    macs += n * (9 * c * 32 + 32 * cfg["keypoint_dims"])     # decoder
    return 2.0 * macs
