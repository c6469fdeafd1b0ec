"""Serving path: BN-folded WiFlow forward through the hand-written kernels.

Counterpart of ``wiflow_tpu/models/fast.py``: ``fast_forward`` with its
default flags (``fuse_tcn``, ``fuse_conv_stack``) and its three
``attention_impl`` lowerings, and ``fast_forward_mmfi``.
``fast_forward(packed, x)`` computes what ``WiFlowPoseModel`` computes in
eval mode, ``[B, 540, 20]`` -> ``[B, 15, 2]``, but

  * every eval BatchNorm is folded into its conv once, by :func:`pack_fast`;
  * the TCN levels, the conv stack and both attention axes run as the
    kernels of ``ops/kernels/`` (on a CPU tensor, their plain versions);
  * the decoder (3x3 conv, 1x1 conv, mean over time) uses stock torch ops,
    as the JAX package leaves it to XLA.

It runs in the config's compute dtype (bf16 by default) with fp32
accumulation inside the kernels, and returns fp32.

``fast_forward_mmfi(packed, x)`` is the same for the MM-Fi model
(``models/wiflow_mmfi.py``): ``[B, 3, 114, 10]`` -> ``[B, 17, 3]`` through
the same three kernels at that model's sizes, a folded 1x1 projection
between the TCN and the conv stack, and a folded 1x1 head on the last time
step, both in stock torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from wiflow_tpu_torch.core.config import ModelConfig, resolve_device
from wiflow_tpu_torch.models.torch_compat import state_dict_from_jax
from wiflow_tpu_torch.models.wiflow_mmfi import MMFiModelConfig
from wiflow_tpu_torch.ops.conv import conv1x1_2d, conv3x3_2d
from wiflow_tpu_torch.ops.kernels.axial_attention import (
    AxisWeights, dual_axial_attention_eval, dual_axial_attention_eval_fused,
    dual_axial_attention_eval_v1, pack_axial_attention,
)
from wiflow_tpu_torch.ops.kernels.conv_stack import (
    ConvStackWeights, fused_conv_stack_eval, pack_conv_stack,
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
    conv: ConvStackWeights
    attention: Tuple[AxisWeights, AxisWeights]
    decoder: Tuple[torch.Tensor, ...]    # w1 [32, C, 3, 3], b1, w2, b2


def _reference_state_dict(weights: Mapping[str, Any],
                          cfg) -> Dict[str, torch.Tensor]:
    """``weights`` as a float32 CPU ``state_dict`` under the reference
    names: a JAX ``{'params', 'batch_stats'}`` tree of numpy arrays is
    renamed and transposed, a torch ``state_dict`` copied."""
    if "params" in weights:
        return state_dict_from_jax(weights, cfg)
    return {k: torch.as_tensor(v).detach().float().cpu()
            for k, v in weights.items()
            if not k.endswith("num_batches_tracked")}


def _conv_bn(sd, conv_key: str, bn_key: str, dev, dt):
    """A conv with a bias and the eval BN after it, folded: (weight, bias)
    in the compute dtype."""
    sc, bi = folded_bn(sd, bn_key)
    w = sd[f"{conv_key}.weight"].float()
    w = w * sc.reshape(-1, *[1] * (w.ndim - 1))
    b = sc * sd[f"{conv_key}.bias"].float() + bi
    return w.to(device=dev, dtype=dt), b.to(device=dev, dtype=dt)


def pack_fast(weights: Mapping[str, Any], config: ModelConfig = ModelConfig(),
              device=None) -> FastWeights:
    """Fold every eval BN of a WiFlow model, once, for :func:`fast_forward`.

    ``weights`` is either a torch ``state_dict`` under the reference names
    (the port module's ``state_dict()``, or ``core/checkpoint.py``'s
    ``load_best_model``) or the JAX ``{'params', 'batch_stats'}`` tree as
    numpy arrays.  ``device`` defaults to CUDA; pass ``"cpu"`` for the CPU.
    A ``config`` with an ablation switch (``tcn_conv``, ``encoder_kind``,
    ``use_attention``) off its default raises ``ValueError``: the serving
    kernels take the default architecture only, as in the JAX package.
    """
    cfg = config
    for name, default in (("tcn_conv", "grouped"), ("encoder_kind", "wiflow"),
                          ("use_attention", True)):
        if getattr(cfg, name) != default:
            raise ValueError(
                f"pack_fast serves the default architecture only: "
                f"{name}={getattr(cfg, name)!r} (the serving kernels take "
                f"{name}={default!r}); run the ablation variant through "
                f"WiFlowPoseModel in eval mode")
    dev = resolve_device(device)
    sd = _reference_state_dict(weights, cfg)
    dt = cfg.dtype
    tcn = pack_tcn_levels(sd, len(cfg.tcn_channels), cfg.tcn_groups,
                          dtype=dt, device=dev)
    conv = pack_conv_stack(sd, len(cfg.conv_channels), dtype=dt, device=dev)
    attention = pack_axial_attention(sd, dtype=dt, device=dev)
    decoder = _conv_bn(sd, "decoder.0", "decoder.1", dev, dt) + _conv_bn(
        sd, "decoder.3", "decoder.4", dev, dt)
    return FastWeights(cfg, dev, tcn, conv, attention, decoder)


# ``attention_impl`` -> the dual attention it selects; any other string is
# the v1 path, as in the JAX package.
_ATTENTION_IMPLS = {"v2": dual_axial_attention_eval,
                    "dual": dual_axial_attention_eval_fused}


def _encode(x: torch.Tensor, tcn, conv, mid=None) -> torch.Tensor:
    """``[B, T, C0]`` through the TCN kernel (one launch a level), ``mid``
    and the conv-stack kernel (one launch) to the attention's input
    ``[B, H, T, C]``, H the conv stack's last width."""
    b, t = x.shape[:2]
    x = fused_tcn_eval(x, tcn)
    if mid is not None:
        x = mid(x)
    y = fused_conv_stack_eval(x.reshape(b * t, x.shape[-1]), conv)
    # [B*T, C, W] -> [B, H=W, T, C]
    return y.reshape(b, t, *y.shape[1:]).permute(0, 3, 1, 2).contiguous()


def fast_forward(packed: FastWeights, x: torch.Tensor,
                 attention_impl: str = "v2") -> torch.Tensor:
    """``[B, 540, 20]`` CSI windows -> ``[B, 15, 2]`` fp32 keypoints.

    ``attention_impl`` selects the lowering of the dual axial attention,
    by the JAX package's rule: ``"v2"`` (default) one kernel launch per
    axis with the QKV projection inside, ``"dual"`` both axes in one
    launch with the intermediate kept on chip, any other string (write
    ``"v1"``) the projection as a stock matrix product and one launch per
    axis on its result.  All three return channels in the standard order,
    so the decoder's weights are the same for each.
    """
    cfg = packed.config
    if x.ndim != 3 or tuple(x.shape[1:]) != (cfg.num_subcarriers,
                                             cfg.window_size):
        raise ValueError(
            f"fast_forward expects [B, {cfg.num_subcarriers}, "
            f"{cfg.window_size}] CSI windows, got {tuple(x.shape)}")
    attend = _ATTENTION_IMPLS.get(attention_impl, dual_axial_attention_eval_v1)
    x = x.to(device=packed.device, dtype=cfg.dtype)
    x = _encode(x.transpose(1, 2).contiguous(), packed.tcn, packed.conv)
    return decode(packed, attend(x, packed.attention))


def decode(packed: FastWeights, x: torch.Tensor) -> torch.Tensor:
    """The folded decoder head, ``[B, 15, T, C]`` -> ``[B, 15, 2]`` fp32:
    3x3 conv -> SiLU -> 1x1 conv -> SiLU -> mean over time."""
    w1, b1, w2, b2 = packed.decoder
    x = F.silu(conv3x3_2d(x, w1, b1))
    x = F.silu(conv1x1_2d(x, w2, b2))
    return x.float().mean(dim=2)


@dataclasses.dataclass(frozen=True)
class FastMMFiWeights:
    """Everything :func:`fast_forward_mmfi` reads, folded and on one
    device."""

    config: MMFiModelConfig
    device: torch.device
    tcn: List[TcnLevelWeights]
    proj: Tuple[torch.Tensor, torch.Tensor]   # w [272, 288], bias
    conv: ConvStackWeights
    attention: Tuple[AxisWeights, AxisWeights]
    head: Tuple[torch.Tensor, ...]            # w1 [32, C, 1, 1], b1, w2, b2


def pack_fast_mmfi(weights: Mapping[str, Any],
                   config: MMFiModelConfig = MMFiModelConfig(),
                   device=None) -> FastMMFiWeights:
    """Fold every eval BN of a ``WiFlowMMFiModel``, once, for
    :func:`fast_forward_mmfi`.  ``weights`` and ``device`` as in
    :func:`pack_fast`."""
    cfg = config
    dev = resolve_device(device)
    sd = _reference_state_dict(weights, cfg)
    dt = cfg.dtype
    tcn = pack_tcn_levels(sd, len(cfg.tcn_channels), cfg.tcn_groups,
                          dtype=dt, device=dev)
    sc, bi = folded_bn(sd, "tcn_proj.1")
    wproj = sd["tcn_proj.0.weight"].float()[:, :, 0] * sc[:, None]
    proj = (wproj.to(device=dev, dtype=dt).contiguous(),
            bi.to(device=dev, dtype=dt))
    conv = pack_conv_stack(sd, len(cfg.conv_channels), dtype=dt, device=dev)
    attention = pack_axial_attention(sd, "att", dtype=dt, device=dev)
    head = _conv_bn(sd, "final_conv.0", "final_conv.1", dev, dt) + (
        sd["final_conv.3.weight"].to(device=dev, dtype=dt),
        sd["final_conv.3.bias"].to(device=dev, dtype=dt))
    return FastMMFiWeights(cfg, dev, tcn, proj, conv, attention, head)


def fast_forward_mmfi(packed: FastMMFiWeights, x: torch.Tensor) -> torch.Tensor:
    """``[B, 3, 114, 10]`` MM-Fi CSI -> ``[B, 17, 3]`` fp32 keypoints.

    Three launches of the TCN kernel, the folded 1x1 projection to 272
    features, one launch of the conv stack, two of the v2 attention on
    ``[B, 17, 10, 64]``, then the folded head on the last time step.
    """
    cfg = packed.config
    if x.ndim != 4 or tuple(x.shape[1:]) != (
            cfg.num_antennas, cfg.num_subcarriers, cfg.window_size):
        raise ValueError(
            f"fast_forward_mmfi expects [B, {cfg.num_antennas}, "
            f"{cfg.num_subcarriers}, {cfg.window_size}] MM-Fi CSI, got "
            f"{tuple(x.shape)}")
    b = x.shape[0]
    x = x.to(device=packed.device, dtype=cfg.dtype)
    x = x.reshape(b, cfg.input_channels, cfg.window_size).transpose(1, 2)
    wproj, bproj = packed.proj
    x = _encode(x.contiguous(), packed.tcn, packed.conv,
                mid=lambda y: F.silu(F.linear(y, wproj, bproj)))
    x = dual_axial_attention_eval(x, packed.attention)   # [B, 17, 10, 64]
    w1, b1, w2, b2 = packed.head
    x = F.silu(conv1x1_2d(x[:, :, -1:, :], w1, b1))      # last time step
    return conv1x1_2d(x, w2, b2)[:, :, 0, :].float()
