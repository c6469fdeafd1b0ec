"""Reference of WiFlow for MM-Fi (``cross_dataset_test/WiFlow/wiflow.py``
of the WiFlow repository): ``[B, 3, 114, 10]`` CSI frames to ``[B, 17,
3]`` keypoints, a projection after the TCN and a head on the last time
step, trained with the pose loss over MM-Fi's skeleton."""

from __future__ import annotations

from typing import Mapping

from benchmark import work
from benchmark.reference import train
from benchmark.reference.model import (
    Run, Tensor, attention, attention_spec, bn_spec, conv1d, conv2d,
    conv_spec, conv_stack, tcn, tcn_spec,
)


def input_shape(cfg: Mapping) -> tuple:
    return (cfg["num_antennas"], cfg["num_subcarriers"], cfg["window_size"])


def spec(cfg: Mapping):
    c, g = cfg["conv_channels"][-1], cfg["attention_groups"]
    proj = cfg["tcn_proj_channels"]
    out = tcn_spec(cfg, cfg["num_antennas"] * cfg["num_subcarriers"])
    out += [("tcn_proj.0.weight", (proj, cfg["tcn_channels"][-1], 1),
             "conv1d")] + bn_spec("tcn_proj.1", proj)
    out += conv_spec(cfg) + attention_spec("att", c, g)
    out += [("final_conv.0.weight", (32, c, 1, 1), "conv2d"),
            ("final_conv.0.bias", (32,), "conv2d_bias")]
    out += bn_spec("final_conv.1", 32)
    out += [("final_conv.3.weight", (cfg["keypoint_dims"], 32, 1, 1),
             "conv2d"),
            ("final_conv.3.bias", (cfg["keypoint_dims"],), "conv2d_bias")]
    return out


def forward(r: Run, x: Tensor, cfg: Mapping) -> Tensor:
    g, b = cfg["attention_groups"], x.shape[0]
    x = r.q(x.float()).reshape(b, -1, cfg["window_size"]).transpose(1, 2)
    x = tcn(r, x, cfg)
    x = r.silu(r.bn(conv1d(r, x, "tcn_proj.0.weight"), "tcn_proj.1"))
    x = conv_stack(r, x[..., None], cfg)             # [B, T, 17, C]
    x = attention(r, x.transpose(1, 2), "att", g)    # [B, 17, T, C]
    x = x[:, :, -1:, :]
    x = r.silu(r.bn(conv2d(r, x, "final_conv.0.weight"), "final_conv.1"))
    return conv2d(r, x, "final_conv.3.weight")[:, :, 0, :]


def loss(pred: Tensor, target: Tensor, cfg: Mapping) -> Tensor:
    return train.pose_loss(pred, target, cfg["loss"])


def forward_flops(cfg: Mapping) -> float:
    """The backbone's, the projection's and the head's products (1x1 convs
    to 32 and to the keypoint dims on the last time step) for one
    sample."""
    t, c = cfg["window_size"], cfg["conv_channels"][-1]
    proj = 2 * t * cfg["tcn_channels"][-1] * cfg["tcn_proj_channels"]
    return (work.backbone_flops(cfg) + proj
            + 2 * cfg["num_keypoints"] * (c * 32 + 32 * cfg["keypoint_dims"]))
