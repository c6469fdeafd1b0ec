"""Serving path: BN-folded WiFlow forward through the hand-written kernels.

Counterpart of ``wiflow_tpu/models/fast.py``: ``fast_forward`` with its
flags (``fuse_tcn``, ``fuse_conv_stack``) and its three ``attention_impl``
lowerings, and ``fast_forward_mmfi``.  ``fast_forward(packed, x)``
computes what ``WiFlowPoseModel`` computes in eval mode, ``[B, 540, 20]``
-> ``[B, 15, 2]``, but

  * every eval BatchNorm is folded into its conv once, by :func:`pack_fast`;
  * the TCN levels, the conv stack and both attention axes run as the
    kernels of ``ops/kernels/`` (on a CPU tensor, their plain versions);
    ``fuse_tcn=False`` / ``fuse_conv_stack=False`` run the TCN levels /
    the conv blocks as stock torch ops instead, on weights that
    :func:`pack_fast` folds a second time, straight from the
    ``state_dict`` and not from the kernels' packs, so that the two
    lowerings tell a kernel fault from a folding fault;
  * the decoder (3x3 conv, 1x1 conv, mean over time) uses stock torch ops,
    as the JAX package leaves it to XLA.

It runs in the config's compute dtype (bf16 by default) with fp32
accumulation inside the kernels, and returns fp32.

``fast_forward_mmfi(packed, x)`` is the same for the MM-Fi model
(``models/wiflow_mmfi.py``): ``[B, 3, 114, 10]`` -> ``[B, 17, 3]`` through
the same three kernels at that model's sizes, a folded 1x1 projection
between the TCN and the conv stack, and a folded 1x1 head on the last time
step, both in stock torch ops.

Spans (``utils/trace.py``): ``serve.forward`` around a call of either
forward, and inside it ``serve.prep`` (the cast and the transposes),
``serve.tcn``, ``serve.project`` (MM-Fi's projection), ``serve.conv_stack``,
``serve.attention`` (each op's kernel wrapper, or its stock lowering) and
``serve.decode`` (the decoder or the head).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from wiflow_tpu_torch.core.config import ModelConfig, resolve_device
from wiflow_tpu_torch.models.torch_compat import state_dict_from_jax
from wiflow_tpu_torch.models.wiflow_mmfi import MMFiModelConfig
from wiflow_tpu_torch.ops.conv import (
    causal_grouped_conv1d, conv1x1_2d, conv1xk_w, conv3x3_2d,
    pointwise_conv1d,
)
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
from wiflow_tpu_torch.utils import trace


class StockTcnLevel(NamedTuple):
    """One TCN level for ``fuse_tcn=False``: each conv with the eval BN
    after it folded, in torch's Conv1d layouts, weights and biases in the
    compute dtype."""

    g1: Tuple[torch.Tensor, torch.Tensor]     # [C_in, C_in/G, 3], [C_in]
    p1: Tuple[torch.Tensor, torch.Tensor]     # [C_out, C_in, 1], [C_out]
    g2: Tuple[torch.Tensor, torch.Tensor]     # [C_out, C_out/G, 3]
    p2: Tuple[torch.Tensor, torch.Tensor]     # [C_out, C_out, 1]
    down: Optional[Tuple[torch.Tensor, torch.Tensor]]   # when C_in != C_out
    dilation: int
    groups: int


class StockConvBlock(NamedTuple):
    """One conv block for ``fuse_conv_stack=False``: the three (1, 3)
    convs ``[C_out, C_in, 1, 3]`` and the 1x1 shortcut ``[C_out, C_in, 1,
    1]``, each with its bias, BN folded, in the compute dtype."""

    convs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    down: Tuple[torch.Tensor, torch.Tensor]
    stride: int


@dataclasses.dataclass(frozen=True)
class FastWeights:
    """Everything :func:`fast_forward` reads, folded and on one device."""

    config: ModelConfig
    device: torch.device
    tcn: List[TcnLevelWeights]
    conv: ConvStackWeights
    attention: Tuple[AxisWeights, AxisWeights]
    decoder: Tuple[torch.Tensor, ...]    # w1 [32, C, 3, 3], b1, w2, b2
    stock_tcn: Tuple[StockTcnLevel, ...]
    stock_conv: Tuple[StockConvBlock, ...]


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
    """A conv (with or without a bias) and the eval BN after it, folded:
    (weight, bias) in the compute dtype."""
    sc, bi = folded_bn(sd, bn_key)
    w = sd[f"{conv_key}.weight"].float()
    w = w * sc.reshape(-1, *[1] * (w.ndim - 1))
    b = sd.get(f"{conv_key}.bias")
    b = bi if b is None else sc * b.float() + bi
    return w.to(device=dev, dtype=dt), b.to(device=dev, dtype=dt)


def _stock_tcn_levels(sd, cfg, dev, dt) -> Tuple[StockTcnLevel, ...]:
    """The TCN levels of ``fuse_tcn=False``, folded from ``sd`` alone."""
    levels = []
    for i in range(len(cfg.tcn_channels)):
        p = f"tcn.network.{i}"
        down = None
        if f"{p}.downsample.0.weight" in sd:
            down = _conv_bn(sd, f"{p}.downsample.0", f"{p}.downsample.1",
                            dev, dt)
        levels.append(StockTcnLevel(
            *(_conv_bn(sd, f"{p}.{conv}", f"{p}.{bn}", dev, dt)
              for conv, bn in (("conv1_group", "bn1_group"),
                               ("conv1_pw", "bn1_pw"),
                               ("conv2_group", "bn2_group"),
                               ("conv2_pw", "bn2_pw"))),
            down, 2 ** i, cfg.tcn_groups))
    return tuple(levels)


def _stock_conv_blocks(sd, cfg, dev, dt) -> Tuple[StockConvBlock, ...]:
    """``up`` and the residual blocks of ``fuse_conv_stack=False``, folded
    from ``sd`` alone."""
    names = ["up"] + [f"residual_blocks.{j}"
                      for j in range(len(cfg.conv_channels))]
    return tuple(StockConvBlock(
        tuple(_conv_bn(sd, f"{p}.block.{conv}", f"{p}.block.{bn}", dev, dt)
              for conv, bn in ((0, 1), (4, 5), (8, 9))),
        _conv_bn(sd, f"{p}.downsample.0", f"{p}.downsample.1", dev, dt),
        1 if k == 0 else 2) for k, p in enumerate(names))


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
    The stock-op layouts of ``fuse_tcn=False`` / ``fuse_conv_stack=False``
    are folded here too, eagerly (a few MB at the default widths).
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
    return FastWeights(cfg, dev, tcn, conv, attention, decoder,
                       _stock_tcn_levels(sd, cfg, dev, dt),
                       _stock_conv_blocks(sd, cfg, dev, dt))


# ``attention_impl`` -> the dual attention it selects; any other string is
# the v1 path, as in the JAX package.
_ATTENTION_IMPLS = {"v2": dual_axial_attention_eval,
                    "dual": dual_axial_attention_eval_fused}


def _conv_stack(x: torch.Tensor, conv) -> torch.Tensor:
    """``[B, T, C0]`` through the conv-stack kernel (one launch) to the
    attention's input ``[B, H, T, C]``, H the conv stack's last width."""
    b, t = x.shape[:2]
    with trace.span("serve.conv_stack"):
        y = fused_conv_stack_eval(x.reshape(b * t, x.shape[-1]), conv)
    # [B*T, C, W] -> [B, H=W, T, C]
    return y.reshape(b, t, *y.shape[1:]).permute(0, 3, 1, 2).contiguous()


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s formula, ``x * (1 / (1 + exp(-x)))``, each op
    rounded to ``x``'s dtype as the JAX package's stock ops round it
    (``F.silu`` rounds once: in bf16 that moves 4 values in 10 by an ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def _stock_tcn_level(lv: StockTcnLevel, x: torch.Tensor) -> torch.Tensor:
    """One folded TCN level in stock ops on ``x [B, T, C_in]``, rounded
    where the JAX package's ``_tcn_level`` rounds: each product
    accumulates in fp32 and is rounded to the compute dtype, then its
    bias is added in that dtype; :func:`_silu`."""
    silu = _silu

    def grouped(h, wb):
        return causal_grouped_conv1d(h, wb[0], dilation=lv.dilation,
                                     groups=lv.groups) + wb[1]

    def pw(h, wb):
        return pointwise_conv1d(h, wb[0]) + wb[1]

    res = x if lv.down is None else pw(x, lv.down)
    h = silu(grouped(x, lv.g1))
    h = silu(pw(h, lv.p1))
    h = silu(grouped(h, lv.g2))
    h = silu(pw(h, lv.p2))
    return silu(h + res)


def _stock_conv_block(blk: StockConvBlock, x: torch.Tensor) -> torch.Tensor:
    """One folded conv block in stock ops on ``x [B, H, W, C_in]`` (the
    JAX package's ``_conv_block``: each (1, 3) conv's bias inside its
    fp32 accumulation, the shortcut's added after its rounding;
    :func:`_silu`).  The (1, 3) convs run in fp32 on the compute dtype's
    values and round once: on CUDA, ``F.conv2d`` adds a bf16 bias after
    rounding the product, a second rounding the JAX op does not make."""
    wd, bd = blk.down
    identity = conv1x1_2d(x, wd, stride_w=blk.stride) + bd
    h = x
    for i, (w, b) in enumerate(blk.convs):
        h = conv1xk_w(h.float(), w.float(), b.float(),
                      stride=blk.stride if i == 0 else 1).to(x.dtype)
        if i < 2:
            h = _silu(h)
    return _silu(h + identity)


def fast_forward(packed: FastWeights, x: torch.Tensor,
                 attention_impl: str = "v2", fuse_tcn: bool = True,
                 fuse_conv_stack: bool = True) -> torch.Tensor:
    """``[B, 540, 20]`` CSI windows -> ``[B, 15, 2]`` fp32 keypoints.

    ``attention_impl`` selects the lowering of the dual axial attention,
    by the JAX package's rule: ``"v2"`` (default) one kernel launch per
    axis with the QKV projection inside, ``"dual"`` both axes in one
    launch with the intermediate kept on chip, any other string (write
    ``"v1"``) the projection as a stock matrix product and one launch per
    axis on its result.  All three return channels in the standard order,
    so the decoder's weights are the same for each.  ``fuse_tcn=False``
    runs the TCN levels as stock ops (each grouped causal conv, each
    folded pointwise conv, the residual) in place of the TCN kernel;
    ``fuse_conv_stack=False`` runs ``up`` and the four stride-2 residual
    blocks as stock ops in place of the conv-stack kernel.  The flags are
    independent of each other and of ``attention_impl``.
    """
    cfg = packed.config
    if x.ndim != 3 or tuple(x.shape[1:]) != (cfg.num_subcarriers,
                                             cfg.window_size):
        raise ValueError(
            f"fast_forward expects [B, {cfg.num_subcarriers}, "
            f"{cfg.window_size}] CSI windows, got {tuple(x.shape)}")
    attend = _ATTENTION_IMPLS.get(attention_impl, dual_axial_attention_eval_v1)
    with trace.span("serve.forward"):
        with trace.span("serve.prep"):
            x = x.to(device=packed.device, dtype=cfg.dtype)
            x = x.transpose(1, 2).contiguous()            # [B, T, C]
        with trace.span("serve.tcn"):
            if fuse_tcn:
                x = fused_tcn_eval(x, packed.tcn)
            else:
                for lv in packed.stock_tcn:
                    x = _stock_tcn_level(lv, x)
        if fuse_conv_stack:
            x = _conv_stack(x, packed.conv)
        else:
            with trace.span("serve.conv_stack"):
                x = x[..., None]                          # [B, T, 240, 1]
                for blk in packed.stock_conv:
                    x = _stock_conv_block(blk, x)
                x = x.transpose(1, 2).contiguous()        # [B, 15, T, 64]
        with trace.span("serve.attention"):
            x = attend(x, packed.attention)
        with trace.span("serve.decode"):
            return decode(packed, x)


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
    with trace.span("serve.forward"):
        with trace.span("serve.prep"):
            x = x.to(device=packed.device, dtype=cfg.dtype)
            x = x.reshape(b, cfg.input_channels, cfg.window_size)
            x = x.transpose(1, 2).contiguous()            # [B, T, C]
        with trace.span("serve.tcn"):
            x = fused_tcn_eval(x, packed.tcn)
        with trace.span("serve.project"):
            wproj, bproj = packed.proj
            x = F.silu(F.linear(x, wproj, bproj))
        x = _conv_stack(x, packed.conv)
        with trace.span("serve.attention"):
            x = dual_axial_attention_eval(x, packed.attention)  # [B,17,10,64]
        with trace.span("serve.decode"):
            w1, b1, w2, b2 = packed.head
            x = F.silu(conv1x1_2d(x[:, :, -1:, :], w1, b1))  # last time step
            return conv1x1_2d(x, w2, b2)[:, :, 0, :].float()
