"""Reference of WiFlow (``models/pose_model.py`` of the WiFlow
repository): ``[B, 540, 20]`` CSI windows to ``[B, 15, 2]`` keypoints,
trained with the pose loss of ``losses/pose_loss.py``."""

from __future__ import annotations

from typing import Mapping

from benchmark import work
from benchmark.reference import train
from benchmark.reference.model import (
    Run, Tensor, attention, attention_spec, bn_spec, conv2d, conv_spec,
    conv_stack, tcn, tcn_spec,
)


def input_shape(cfg: Mapping) -> tuple:
    return (cfg["num_subcarriers"], cfg["window_size"])


def spec(cfg: Mapping):
    c, g = cfg["conv_channels"][-1], cfg["attention_groups"]
    out = tcn_spec(cfg, cfg["num_subcarriers"]) + conv_spec(cfg)
    out += attention_spec("attention", c, g)
    out += [("decoder.0.weight", (32, c, 3, 3), "conv2d"),
            ("decoder.0.bias", (32,), "conv2d_bias")]
    out += bn_spec("decoder.1", 32)
    out += [("decoder.3.weight", (cfg["keypoint_dims"], 32, 1, 1), "conv2d"),
            ("decoder.3.bias", (cfg["keypoint_dims"],), "conv2d_bias")]
    out += bn_spec("decoder.4", cfg["keypoint_dims"])
    return out


def forward(r: Run, x: Tensor, cfg: Mapping) -> Tensor:
    g = cfg["attention_groups"]
    x = r.q(x.float()).transpose(1, 2)                   # [B, T, C]
    x = conv_stack(r, tcn(r, x, cfg)[..., None], cfg)    # [B, T, 15, C]
    x = attention(r, x.transpose(1, 2), "attention", g)  # [B, 15, T, C]
    x = r.silu(r.bn(conv2d(r, x, "decoder.0.weight", padding=1),
                    "decoder.1"))
    x = r.silu(r.bn(conv2d(r, x, "decoder.3.weight"), "decoder.4"))
    return x.mean(dim=2)


def loss(pred: Tensor, target: Tensor, cfg: Mapping) -> Tensor:
    return train.pose_loss(pred, target, cfg["loss"])


def forward_flops(cfg: Mapping) -> float:
    """The backbone's and the decoder's products (a 3x3 conv to 32 and a
    1x1 to the keypoint dims over every time step) for one sample."""
    h, w = cfg["num_keypoints"], cfg["window_size"]
    c = cfg["conv_channels"][-1]
    return (work.backbone_flops(cfg)
            + 2 * h * w * (9 * c * 32 + 32 * cfg["keypoint_dims"]))
