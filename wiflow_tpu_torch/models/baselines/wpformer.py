"""WPformer baseline: multi-stream ResNet34 + channel transformer.

Counterpart of ``wiflow_tpu/models/baselines/wpformer.py`` (ref
baseline/WPformer/model.py:281-452, ChannelTrans.py:24-291):

  [B, 540, 20] -> 18 chunks of 30 subcarriers, each resized to 60x32
  one shared ResNet34 stem + layers1-3 (1-channel 3x3 stem, no maxpool),
  the 18 streams as one batch
  concat on width -> [B, 15, 144, 256] -> BN
  ChannelTransformer (channel-wise attention, 3 heads, 1 layer,
  InstanceNorm on the scores) with learned position embeddings
  conv decode -> mean over width -> BN1d -> [B, 15, 2]

``wpformer_mmfi``: 3 antenna streams of 114x10 CSI resized to 136x32,
layers 1-4 (512 channels), ``[B, 17, 3]`` (ref cross_dataset_test/
WPformer/metafi.py:39-207).  ``resnet34_warm_start`` maps a torchvision
ResNet34 ``state_dict`` onto the trunk (ref model.py:302-344).  Layout and
names as in ``models/baselines/hpeli.py``; flax's ``nn.LayerNorm`` (eps
1e-6 here) and tanh ``nn.gelu`` are kept, and the four dropouts of the
transformer are the reference's 0.1.

Served (eval): :func:`pack_wpformer` once, then :func:`wpformer_forward`,
bf16 throughout, the channel attention's core on
``ops/kernels/channel_attention.py``'s kernel on a CUDA device.  The
train-mode forward keeps the stock ops (:func:`channel_attention_core`).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wiflow_tpu_torch.core.config import resolve_device
from wiflow_tpu_torch.models.baselines.convert import FlaxLayout
from wiflow_tpu_torch.models.baselines.hpeli import conv2d, flax_param
from wiflow_tpu_torch.models.baselines.performer import dense, layer_norm
from wiflow_tpu_torch.models.baselines.wisppn import resize_bilinear
from wiflow_tpu_torch.models.layers import TorchBatchNorm, TorchDropout
from wiflow_tpu_torch.ops.kernels.channel_attention import (
    channel_attention, split_heads,
)
from wiflow_tpu_torch.utils import trace


class ResBasicBlock(nn.Module):
    """ResNet34 basic block.  Its 3x3 convs pad (1, 1) as torch's
    ``Conv2d(padding=1)`` does, also at stride 2, where XLA's ``"SAME"``
    would pad (0, 1)."""

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
            self.down_weight = flax_param((1, 1, cin, cout), "he_normal",
                                          generator, device)
            self.down_bn = TorchBatchNorm(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, pad = (self.stride, self.stride), [(1, 1), (1, 1)]
        y = torch.relu(self.bn1(conv2d(x, self.conv1_weight, stride=s,
                                       padding=pad)))
        y = self.bn2(conv2d(y, self.conv2_weight, padding=pad))
        if self.down:
            x = self.down_bn(conv2d(x, self.down_weight, stride=s,
                                    padding="VALID"))
        return torch.relu(y + x)


class ResNet34Trunk(nn.Module):
    """ResNet34 stem + layers: a 3x3 stride-1 stem on one channel, no
    maxpool (ref model.py:335-344, 403-415)."""

    def __init__(self, widths: Sequence[int] = (64, 128, 256),
                 blocks: Sequence[int] = (3, 4, 6), *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.stem_weight = flax_param((3, 3, 1, 64), "he_normal", generator,
                                      device)
        self.stem_bn = TorchBatchNorm(64, device=device)
        self.names, c = [], 64
        for li, (width, n) in enumerate(zip(widths, blocks)):
            for bi in range(n):
                stride = 2 if li > 0 and bi == 0 else 1
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, ResBasicBlock(
                    c, width, stride, generator=generator, device=device))
                self.names.append(name)
                c = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem_bn(conv2d(x, self.stem_weight)))
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class ChannelAttention(nn.Module):
    """Channel-wise attention (ref ChannelTrans.py:82-168): per-head
    ``[C, C]`` Q/K/V over the channels, scores ``[C, C]`` instance-normed
    per head, softmax, the heads' mean."""

    def __init__(self, channels: int, heads: int = 3, dropout: float = 0.1,
                 dropout_generator: torch.Generator | None = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.channels, self.heads = channels, heads
        for i in range(heads):
            for w in ("wq", "wk", "wv"):
                self.register_parameter(f"{w}{i}", flax_param(
                    (channels, channels), "xavier_uniform", generator,
                    device))
        self.wo = flax_param((channels, channels), "xavier_uniform",
                             generator, device)
        self.attn_drop = TorchDropout(dropout, dropout_generator)
        self.proj_drop = TorchDropout(dropout, dropout_generator)

    def head_weights(self, w: str):
        """The heads' ``[C, C]`` matrices of ``w`` (``"wq"``, ``"wk"``,
        ``"wv"``; ``"wo"``, the output's, is one), each used as ``x @ m``."""
        if w == "wo":
            return self.wo
        return [getattr(self, f"{w}{i}") for i in range(self.heads)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def heads(w):
            return torch.stack([x @ m.to(x.dtype)
                                for m in self.head_weights(w)], dim=1)

        q, k, v = heads("wq"), heads("wk"), heads("wv")     # [B, H, N, C]
        ctx = channel_attention_core(q, k, v, self.attn_drop)
        return self.proj_drop(ctx @ self.head_weights("wo").to(x.dtype))


def channel_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           drop=None) -> torch.Tensor:
    """The model's core in stock ops: ``q, k, v [B, H, N, C]`` -> the
    heads' mean context ``[B, N, C]`` in ``q``'s dtype.  Scores ``[C, C]``
    in fp32, InstanceNorm over each head's whole map, row softmax rounded
    to ``q``'s dtype, ``drop`` (the attention dropout) on it, each head's
    context rounded before the mean."""
    scores = torch.einsum("bhnc,bhnd->bhcd", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    # InstanceNorm2d(heads), affine=False: per (b, h) over [C, C]
    mean = scores.mean(dim=(-2, -1), keepdim=True)
    var = scores.var(dim=(-2, -1), keepdim=True, unbiased=False)
    scores = (scores - mean) * torch.rsqrt(var + 1e-5)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if drop is not None:
        probs = drop(probs)
    ctx = torch.einsum("bhcd,bhnd->bhcn", probs.float(),
                       v.float()).to(q.dtype)
    return ctx.permute(0, 3, 2, 1).mean(dim=3)              # [B, N, C]


class ChannelTransformer(nn.Module):
    """Position embedding -> encoder layer(s) -> 1x1 conv + BN + ReLU
    reconstruction + residual (ref ChannelTrans.py:193-291).  ``forward``
    reaches its weights through :meth:`layer_parts` and :meth:`outer_parts`
    (and the attention through ``head_weights``), which
    ``hpeli_zoo.ReferenceChannelTransformer`` overrides to hold the same
    computation under the reference's names."""

    def __init__(self, channels: int, spatial: Sequence[int],
                 num_layers: int = 1, heads: int = 3,
                 dropout_generator: torch.Generator | None = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.channels, self.num_layers = channels, num_layers
        self.spatial = tuple(spatial)
        n = self.spatial[0] * self.spatial[1]
        c = channels
        self.position_embeddings = flax_param((1, n, c), "zeros", generator,
                                              device)
        self.emb_drop = TorchDropout(0.1, dropout_generator)
        for i in range(num_layers):
            self.add_module(f"attn_norm_{i}", nn.LayerNorm(
                c, eps=1e-6, device=device))
            self.add_module(f"attn_{i}", ChannelAttention(
                c, heads, 0.1, dropout_generator, generator=generator,
                device=device))
            self.add_module(f"ffn_norm_{i}", nn.LayerNorm(
                c, eps=1e-6, device=device))
            self.add_module(f"mlp_in_{i}", dense(c, 4 * c, generator, device))
            self.add_module(f"mlp_drop1_{i}",
                            TorchDropout(0.1, dropout_generator))
            self.add_module(f"mlp_out_{i}", dense(4 * c, c, generator, device))
            self.add_module(f"mlp_drop2_{i}",
                            TorchDropout(0.1, dropout_generator))
        self.encoder_norm = nn.LayerNorm(c, eps=1e-6, device=device)
        self.rec_weight = flax_param((1, 1, c, c), "he_normal", generator,
                                     device)
        self.rec_bias = flax_param((c,), "zeros", generator, device)
        self.rec_bn = TorchBatchNorm(c, device=device)

    def layer_parts(self, i: int):
        """Layer ``i``'s modules: attention norm, attention, FFN norm, FFN
        in, its dropout, FFN out, its dropout."""
        return tuple(getattr(self, f"{n}_{i}") for n in (
            "attn_norm", "attn", "ffn_norm", "mlp_in", "mlp_drop1",
            "mlp_out", "mlp_drop2"))

    def outer_parts(self):
        """Position embeddings, their dropout, the encoder's last norm, and
        the reconstruction's OIHW weight, bias and BatchNorm."""
        return (self.position_embeddings, self.emb_drop, self.encoder_norm,
                self.rec_weight, self.rec_bias, self.rec_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h, w = self.spatial
        pos, emb_drop, encoder_norm, rec_w, rec_b, rec_bn = self.outer_parts()
        t = x.reshape(b, h * w, self.channels)
        t = emb_drop(t + pos.to(x.dtype))
        for i in range(self.num_layers):
            attn_norm, attn, ffn_norm, mlp_in, drop1, mlp_out, drop2 = (
                self.layer_parts(i))
            t = t + attn(layer_norm(attn_norm, t))
            y = layer_norm(ffn_norm, t)
            y = torch.nn.functional.gelu(mlp_in(y), approximate="tanh")
            t = t + drop2(mlp_out(drop1(y)))
        t = layer_norm(encoder_norm, t)
        y = conv2d(t.reshape(b, h, w, self.channels), rec_w, rec_b)
        return torch.relu(rec_bn(y)) + x


class WPformer(FlaxLayout, nn.Module):
    """posenet (ref model.py:281-452).  ``input_mode='wiflow'``:
    ``[B, 540, 20]`` -> 18 subcarrier chunks resized to 60x32, ResNet34
    layers 1-3, ``[B, 15, 2]``; ``'mmfi'``: see :func:`wpformer_mmfi`.
    Built on ``device`` in eval mode, parameters from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None); ``dropout_generator``, on the
    model's device, draws the transformer's dropout masks."""

    def __init__(self, num_chunks: int = 18,
                 resize_to: Sequence[int] = (60, 32),
                 num_keypoints: int = 15, keypoint_dims: int = 2,
                 trunk_widths: Sequence[int] = (64, 128, 256),
                 trunk_blocks: Sequence[int] = (3, 4, 6), heads: int = 3,
                 input_mode: str = "wiflow", compute_dtype: str = "bfloat16",
                 *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if input_mode not in ("wiflow", "mmfi"):
            raise ValueError(f"input_mode={input_mode!r}: 'wiflow' or 'mmfi'")
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.dropout_generator = torch.Generator(device=dev)
        self.num_chunks, self.resize_to = num_chunks, tuple(resize_to)
        self.input_mode, self.compute_dtype = input_mode, compute_dtype
        self.keypoint_dims = keypoint_dims
        self.trunk = ResNet34Trunk(trunk_widths, trunk_blocks, generator=gen,
                                   device=dev)
        fh, fw = self.resize_to
        for _ in trunk_widths[1:]:              # a 3x3 stride-2 conv, pad 1
            fh, fw = (fh - 1) // 2 + 1, (fw - 1) // 2 + 1
        fc = trunk_widths[-1]
        self.pre_tf_bn = TorchBatchNorm(fc, device=dev)
        self.tf = ChannelTransformer(fc, (fh, num_chunks * fw), heads=heads,
                                     dropout_generator=self.dropout_generator,
                                     generator=gen, device=dev)
        self.decode_conv1_weight = flax_param((3, 3, fc, 32), "he_normal",
                                              gen, dev)
        self.decode_bn1 = TorchBatchNorm(32, device=dev)
        self.decode_conv2_weight = flax_param((1, 1, 32, keypoint_dims),
                                              "he_normal", gen, dev)
        self.decode_bn2 = TorchBatchNorm(keypoint_dims, device=dev)
        self.final_bn = TorchBatchNorm(keypoint_dims, device=dev)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.to(getattr(torch, self.compute_dtype))
        # the streams through the one shared trunk as one batch (the
        # reference loops over them, model.py:398-415)
        if self.input_mode == "mmfi":
            xs = x.reshape(b * self.num_chunks, x.shape[2], x.shape[3])
        else:
            xs = x.reshape(b * self.num_chunks, x.shape[1] // self.num_chunks,
                           x.shape[2])
        feats = self.trunk(resize_bilinear(xs[..., None], self.resize_to))
        fh, fw, fc = feats.shape[1:]
        # concat the streams along width (model.py:421)
        feats = feats.reshape(b, self.num_chunks, fh, fw, fc).transpose(1, 2)
        feats = self.pre_tf_bn(feats.reshape(b, fh, self.num_chunks * fw, fc))
        feats = self.tf(feats)
        y = torch.relu(self.decode_bn1(conv2d(feats,
                                              self.decode_conv1_weight)))
        y = torch.relu(self.decode_bn2(conv2d(y, self.decode_conv2_weight)))
        # mean over width, then BatchNorm1d(D) over (B, K)
        return self.final_bn(y.float().mean(dim=2))        # [B, K, D]


class ServedLayer(NamedTuple):
    """One encoder layer's weights in the compute dtype."""

    attn_norm: nn.LayerNorm
    wqkv: torch.Tensor       # [C, 3 H C]: q_0 .. q_{H-1}, k_0 .., v_0 ..
    wo: torch.Tensor         # [C, C]
    ffn_norm: nn.LayerNorm
    w_in: torch.Tensor       # [4C, C], as nn.Linear holds it
    b_in: torch.Tensor
    w_out: torch.Tensor      # [C, 4C]
    b_out: torch.Tensor


class ServedWPformer(NamedTuple):
    """What :func:`wpformer_forward` reads: the eval model (its trunk, its
    BatchNorms and LayerNorms) and its transformer's weights packed once
    in the compute dtype."""

    model: "WPformer"
    dtype: torch.dtype
    heads: int
    pos: torch.Tensor        # [1, N, C]
    layers: Tuple[ServedLayer, ...]
    rec_w: torch.Tensor      # [C, C, 1, 1]
    rec_b: torch.Tensor      # [C]


@torch.no_grad()
def pack_wpformer(model: "WPformer") -> ServedWPformer:
    """Pack ``model`` (put in eval mode) for :func:`wpformer_forward`: each
    layer's 3 H head projections side by side as one ``[C, 3 H C]``
    matrix, and every transformer weight in the compute dtype."""
    model.eval()
    dt = getattr(torch, model.compute_dtype)
    tf = model.tf
    pos, _, _, rec_w, rec_b, _ = tf.outer_parts()
    layers = []
    for i in range(tf.num_layers):
        attn_norm, attn, ffn_norm, mlp_in, _, mlp_out, _ = tf.layer_parts(i)
        wqkv = torch.cat([m for w in ("wq", "wk", "wv")
                          for m in attn.head_weights(w)], dim=1)
        layers.append(ServedLayer(
            attn_norm, wqkv.to(dt).contiguous(),
            attn.head_weights("wo").to(dt).contiguous(), ffn_norm,
            mlp_in.weight.to(dt), mlp_in.bias.to(dt),
            mlp_out.weight.to(dt), mlp_out.bias.to(dt)))
    heads = tf.layer_parts(0)[1].heads
    return ServedWPformer(model, dt, heads, pos.to(dt), tuple(layers),
                          rec_w.to(dt), rec_b.to(dt))


def _served_core(qkv: torch.Tensor, heads: int, core: str) -> torch.Tensor:
    if core == "kernel":
        trace.count("serve.channel_attention_windows", qkv.shape[0])
        return channel_attention(qkv, heads)
    return channel_attention_core(*split_heads(qkv, heads))


@torch.no_grad()
def wpformer_forward(packed: ServedWPformer, x: torch.Tensor,
                     core: str = "auto") -> torch.Tensor:
    """Eval forward of the packed model (``input_mode='wiflow'``):
    ``[B, 540, 20]`` CSI windows -> ``[B, 15, 2]`` fp32 keypoints, on the
    model's device.

    The model's own layers, in its compute dtype throughout: where the
    eval forward lets each LayerNorm's fp32 output carry the transformer
    in fp32, this one rounds it to the compute dtype, so the projections,
    the core and the MLP run on bf16 tensor cores.  ``core`` lowers the
    channel attention's core: ``"kernel"`` the hand-written kernel
    (``ops/kernels/channel_attention.py``; its plain version on the CPU),
    ``"stock"`` the model's stock ops, ``"auto"`` (the default) the
    kernel on a CUDA device in bfloat16 and the stock ops elsewhere.

    Spans: ``serve.forward`` > ``serve.prep`` (chunks and resize),
    ``serve.trunk`` (the shared ResNet trunk over every stream),
    ``serve.channel_attention`` (the BatchNorm before it, the channel
    transformer, its reconstruction and residual), ``serve.decode``;
    counters ``serve.wpformer_streams`` (trunk images: streams x rows) and
    ``serve.channel_attention_windows`` (windows whose core went through
    the kernel's wrapper)."""
    m = packed.model
    if m.input_mode != "wiflow":
        raise ValueError("wpformer_forward serves input_mode 'wiflow' only")
    dev = m.tf.position_embeddings.device
    if core == "auto":
        core = ("kernel" if dev.type == "cuda"
                and packed.dtype == torch.bfloat16 else "stock")
    if core not in ("kernel", "stock"):
        raise ValueError(f"core={core!r}: 'auto', 'kernel' or 'stock'")
    dt = packed.dtype
    with trace.span("serve.forward"):
        with trace.span("serve.prep"):
            b = x.shape[0]
            x = x.to(device=dev, dtype=dt)
            xs = x.reshape(b * m.num_chunks, x.shape[1] // m.num_chunks,
                           x.shape[2])
            xs = resize_bilinear(xs[..., None], m.resize_to)
            trace.count("serve.wpformer_streams", xs.shape[0])
        with trace.span("serve.trunk"):
            feats = m.trunk(xs)
        with trace.span("serve.channel_attention"):
            fh, fw, fc = feats.shape[1:]
            feats = feats.reshape(b, m.num_chunks, fh, fw, fc).transpose(1, 2)
            feats = m.pre_tf_bn(feats.reshape(b, fh, m.num_chunks * fw, fc))
            t = feats.reshape(b, -1, fc) + packed.pos
            for lay in packed.layers:
                y = layer_norm(lay.attn_norm, t).to(dt)
                ctx = _served_core(y @ lay.wqkv, packed.heads, core)
                t = t + ctx @ lay.wo
                y = layer_norm(lay.ffn_norm, t).to(dt)
                y = F.gelu(F.linear(y, lay.w_in, lay.b_in), approximate="tanh")
                t = t + F.linear(y, lay.w_out, lay.b_out)
            _, _, encoder_norm, _, _, rec_bn = m.tf.outer_parts()
            t = layer_norm(encoder_norm, t).to(dt)
            y = conv2d(t.reshape(feats.shape), packed.rec_w, packed.rec_b)
            feats = torch.relu(rec_bn(y)) + feats
        with trace.span("serve.decode"):
            y = torch.relu(m.decode_bn1(conv2d(feats,
                                               m.decode_conv1_weight)))
            y = torch.relu(m.decode_bn2(conv2d(y, m.decode_conv2_weight)))
            return m.final_bn(y.float().mean(dim=2))


def wpformer_mmfi(compute_dtype: str = "bfloat16", *, device=None,
                  generator: torch.Generator | None = None) -> WPformer:
    """WPformer on MM-Fi: 3 antenna streams, ResNet34 layers 1-4,
    ``[B, 17, 3]`` (ref cross_dataset_test/WPformer/metafi.py:39-207)."""
    return WPformer(num_chunks=3, resize_to=(136, 32), num_keypoints=17,
                    keypoint_dims=3, trunk_widths=(64, 128, 256, 512),
                    trunk_blocks=(3, 4, 6, 3), input_mode="mmfi",
                    compute_dtype=compute_dtype, device=device,
                    generator=generator)


def resnet34_warm_start(state_dict: Mapping[str, torch.Tensor],
                        widths: Sequence[int] = (64, 128, 256),
                        blocks: Sequence[int] = (3, 4, 6)
                        ) -> Dict[str, torch.Tensor]:
    """A torchvision ``resnet34`` ``state_dict`` as entries of the WPformer
    ``state_dict`` (``trunk.*``), the reference's ImageNet warm start (ref
    model.py:302-344): ``bn1`` and ``layer1..`` are adopted, the stem conv
    is not (the model's stem takes one channel).  Both layouts are OIHW,
    so the values pass as they are."""
    def t(key):
        return torch.as_tensor(state_dict[key]).detach().float().cpu()

    def bn(dst, src):
        return {f"{dst}.{k}": t(f"{src}.{k}")
                for k in ("weight", "bias", "running_mean", "running_var")}

    out = bn("trunk.stem_bn", "bn1")
    for li, n in enumerate(blocks[:len(widths)]):
        for bi in range(n):
            tp, name = f"layer{li + 1}.{bi}", f"trunk.layer{li + 1}_{bi}"
            out[f"{name}.conv1_weight"] = t(f"{tp}.conv1.weight")
            out[f"{name}.conv2_weight"] = t(f"{tp}.conv2.weight")
            out.update(bn(f"{name}.bn1", f"{tp}.bn1"))
            out.update(bn(f"{name}.bn2", f"{tp}.bn2"))
            if f"{tp}.downsample.0.weight" in state_dict:
                out[f"{name}.down_weight"] = t(f"{tp}.downsample.0.weight")
                out.update(bn(f"{name}.down_bn", f"{tp}.downsample.1"))
    return out


def merge_warm_start(state_dict: Mapping[str, torch.Tensor],
                     warm: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``state_dict`` with the entries of ``warm`` (from
    :func:`resnet34_warm_start`) in place of its own; every key of
    ``warm`` must be one of ``state_dict``'s."""
    unknown = sorted(set(warm) - set(state_dict))
    if unknown:
        raise KeyError(f"warm-start keys not in the model: {unknown[:5]}")
    return {**state_dict, **warm}
