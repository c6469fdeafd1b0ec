"""Serving path: BN-folded WiFlow forward through the hand-written kernels.

Counterpart of ``wiflow_tpu/models/fast.py::fast_forward`` with its
default flags (``fuse_tcn``, ``fuse_conv_stack``, ``attention_impl="v2"``).
``fast_forward(packed, x)`` computes what ``WiFlowPoseModel`` computes in
eval mode, ``[B, 540, 20]`` -> ``[B, 15, 2]``, but

  * every eval BatchNorm is folded into its conv once, by :func:`pack_fast`;
  * the TCN levels, the conv stack and both attention axes run as the
    kernels of ``ops/kernels/`` (on a CPU tensor, their plain versions);
  * the decoder (3x3 conv, 1x1 conv, mean over time) uses stock torch ops,
    as the JAX package leaves it to XLA.

It runs in the config's compute dtype (bf16 by default) with fp32
accumulation inside the kernels, and returns fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from wiflow_tpu_torch.core.config import ModelConfig, resolve_device
from wiflow_tpu_torch.models.torch_compat import state_dict_from_jax
from wiflow_tpu_torch.ops.conv import conv1x1_2d, conv3x3_2d
from wiflow_tpu_torch.ops.kernels.axial_attention import (
    AxisWeights, dual_axial_attention_eval, pack_axial_attention,
)
from wiflow_tpu_torch.ops.kernels.conv_stack import (
    ConvBlockWeights, fused_conv_stack_eval, pack_conv_stack,
)
from wiflow_tpu_torch.ops.kernels.tcn_level import (
    TcnLevelWeights, fused_tcn_eval, pack_tcn_levels,
)
from wiflow_tpu_torch.ops.norm import folded_bn


@dataclasses.dataclass(frozen=True)
class FastWeights:
    """Everything :func:`fast_forward` reads, folded and on one device."""

    config: ModelConfig
    device: torch.device
    tcn: List[TcnLevelWeights]
    conv: List[ConvBlockWeights]
    attention: Tuple[AxisWeights, AxisWeights]
    decoder: Tuple[torch.Tensor, ...]    # w1 [32, C, 3, 3], b1, w2, b2


def pack_fast(weights: Mapping[str, Any], config: ModelConfig = ModelConfig(),
              device=None) -> FastWeights:
    """Fold every eval BN of a WiFlow model, once, for :func:`fast_forward`.

    ``weights`` is either a torch ``state_dict`` under the reference names
    (the port module's ``state_dict()``, or ``core/checkpoint.py``'s
    ``load_best_model``) or the JAX ``{'params', 'batch_stats'}`` tree as
    numpy arrays.  ``device`` defaults to CUDA; pass ``"cpu"`` for the CPU.
    """
    cfg = config
    dev = resolve_device(device)
    if "params" in weights:
        sd = state_dict_from_jax(weights, cfg)
    else:
        sd = {k: torch.as_tensor(v).detach().float().cpu()
              for k, v in weights.items()
              if not k.endswith("num_batches_tracked")}
    dt = cfg.dtype
    tcn = pack_tcn_levels(sd, len(cfg.tcn_channels), cfg.tcn_groups,
                          dtype=dt, device=dev)
    conv = pack_conv_stack(sd, len(cfg.conv_channels), dtype=dt, device=dev)
    attention = pack_axial_attention(sd, dtype=dt, device=dev)

    def conv_bn(conv_key, bn_key):
        sc, bi = folded_bn(sd, bn_key)
        w = sd[f"{conv_key}.weight"].float() * sc[:, None, None, None]
        b = sc * sd[f"{conv_key}.bias"].float() + bi
        return w.to(device=dev, dtype=dt), b.to(device=dev, dtype=dt)

    decoder = conv_bn("decoder.0", "decoder.1") + conv_bn("decoder.3",
                                                          "decoder.4")
    return FastWeights(cfg, dev, tcn, conv, attention, decoder)


def fast_forward(packed: FastWeights, x: torch.Tensor) -> torch.Tensor:
    """``[B, 540, 20]`` CSI windows -> ``[B, 15, 2]`` fp32 keypoints."""
    cfg = packed.config
    if x.ndim != 3 or tuple(x.shape[1:]) != (cfg.num_subcarriers,
                                             cfg.window_size):
        raise ValueError(
            f"fast_forward expects [B, {cfg.num_subcarriers}, "
            f"{cfg.window_size}] CSI windows, got {tuple(x.shape)}")
    b, t = x.shape[0], cfg.window_size
    x = x.to(device=packed.device, dtype=cfg.dtype)
    x = fused_tcn_eval(x.transpose(1, 2).contiguous(), packed.tcn)
    y = fused_conv_stack_eval(x.reshape(b * t, x.shape[-1]), packed.conv)
    # [B*T, C, W] -> [B, H=W(=15), T, C]
    x = y.reshape(b, t, *y.shape[1:]).permute(0, 3, 1, 2).contiguous()
    return decode(packed, dual_axial_attention_eval(x, packed.attention))


def decode(packed: FastWeights, x: torch.Tensor) -> torch.Tensor:
    """The folded decoder head, ``[B, 15, T, C]`` -> ``[B, 15, 2]`` fp32:
    3x3 conv -> SiLU -> 1x1 conv -> SiLU -> mean over time."""
    w1, b1, w2, b2 = packed.decoder
    x = F.silu(conv3x3_2d(x, w1, b1))
    x = F.silu(conv1x1_2d(x, w2, b2))
    return x.float().mean(dim=2)
