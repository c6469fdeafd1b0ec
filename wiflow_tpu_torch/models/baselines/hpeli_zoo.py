"""HPE-Li's model zoo, part 2: the SKNet variants and the pose models of
the robustness experiments, with the reference's ``state_dict`` names.

Counterpart of ``wiflow_tpu/models/baselines/hpeli_zoo.py`` (ref
cross_dataset_test/HPE-Li/model/):

  * utils/SKNet.py:9-173      — SKConv/SKUnit with pool_dim
    'freq'/'freq-time'/'freq-chan' branch attention (OriginalHPE, the
    denoiser HPE variants, HPEWiPoseModel),
  * utils/SKNet_v2.py:1-162   — SKConv/SKUnit v2 (channel + frequency
    attention summed),
  * HPE_no_denoiser.py:9-73   — OriginalHPE (MM-Fi [B,3,114,10]->[B,17,2]),
  * HPE_basic_cnn.py:9-50     — BasicCnnHPE,
  * HPE_Wipose.py:9-100       — HPEWiPoseModel (WiPose [B,9,30,5]->[B,18,2]),
  * sknet_trans_mmfi.py:10-207 / sknet_trans_wipose.py:10-205 —
    SKConv with a ChannelTransformer, DSKNetTransMMFi / DSKNetTransWipose.

Tensors stay in torch's NCHW order, as in the JAX module, because the
reference reinterprets NCHW buffers; three such reinterpretations are kept
as reshapes of contiguous tensors (a reshape reads the buffer in its
logical order, as ``.view`` does; a permute would give other numbers):

  1. SKNet.py:84 views the branch maps [B, M*C, H, W] as [B, M, H, C, W];
  2. SKNet.py:103 views the [B, H, C] descriptor as [B, C, H];
  3. SKNet.py:110-111 softmaxes attention in [B, M, C, H, 1] and views it
     back as [B, M, H, C, 1].

Also kept: SKNet.py:138 hard-codes M=4, G=1, r=4 in the SKConv that its
SKUnit builds, whatever the caller passes.

Names: every module holds its weights under the reference's torch names
(``skunit1.conv2_sk.0.convs.0.0.weight`` ...), so a reference checkpoint
loads with ``load_state_dict``.  The reference's SKUnit of SKNet.py also
stores ``conv3`` and ``shortcut`` weights that its forward never applies,
and SKNet_v2.py's SKConv a ``norm`` it never applies; the modules here do
not hold them, and drop those keys, by name, when a ``state_dict`` is
loaded.  Each top-level model's :meth:`spec` is this module's copy of the
JAX package's spec (``*_spec()``, ``hpeli_zoo.py:524-689``): the torch
key, the flax path and the layout functions of every weight, which
:func:`state_dict_from_spec` and :func:`variables_from_spec` apply.

The weights are drawn from a CPU ``torch.Generator`` with the JAX module's
initializers (torch's default conv init, flax's ``nn.Dense`` init in the
regression head).  Every model is fp32, as in the JAX package; the
convolutions and products are stock torch ops (no TPU kernel backs them
there), which want TF32 off on the card (``core/config.py::exact_fp32``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wiflow_tpu_torch.core.config import resolve_device
from wiflow_tpu_torch.models.baselines.hpeli import flax_param
from wiflow_tpu_torch.models.baselines.sknet_trans import RegressionHead
from wiflow_tpu_torch.models.baselines.wpformer import (
    ChannelAttention, ChannelTransformer,
)
from wiflow_tpu_torch.models.baselines.performer import dense
from wiflow_tpu_torch.models.layers import (
    ChannelFirstBatchNorm, TorchBatchNorm, TorchDropout,
)

Path = Tuple[str, ...]
# (torch key, collection, flax path, torch -> flax, flax -> torch)
Spec = Tuple[str, str, Path, Callable, Callable]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def avg_pool_nchw(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """torch ``AvgPool2d((kh, kw))``: stride = kernel, floor mode."""
    return F.avg_pool2d(x, (kh, kw))


def torch_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``module``'s weight and bias again from ``generator`` with
    torch's default conv / linear init, which the JAX module copies
    (``torch_conv_default``): U(+-1/sqrt(fan_in)), fan_in from
    ``weight.size(1)`` and the kernel (for ``ConvTranspose2d`` too: torch's
    quirk)."""
    with torch.no_grad():
        bound = 1.0 / math.sqrt(module.weight[0].numel())
        for p in (module.weight, module.bias):
            if p is not None:
                p.copy_(torch.empty(p.shape).uniform_(
                    -bound, bound, generator=generator))
    return module


def conv(cin: int, cout: int, k, *, generator: torch.Generator, device,
         groups: int = 1, bias: bool = False, padding=0, dilation=1,
         ndim: int = 2) -> nn.Module:
    """An ``nn.Conv2d`` (``ndim=1``: ``nn.Conv1d``) with torch's init drawn
    from ``generator``."""
    cls = nn.Conv2d if ndim == 2 else nn.Conv1d
    return torch_init_(cls(cin, cout, k, padding=padding, dilation=dilation,
                           groups=groups, bias=bias, device=device),
                       generator)


def linear(cin: int, cout: int, *, generator: torch.Generator, device,
           bias: bool = True) -> nn.Linear:
    """An ``nn.Linear`` with torch's init drawn from ``generator``."""
    return torch_init_(nn.Linear(cin, cout, bias=bias, device=device),
                       generator)


def _drop_dead_keys(names: Sequence[str]):
    """A load-state-dict pre-hook that removes ``prefix + name`` keys:
    weights the reference stores and its forward never applies."""
    def hook(state_dict, prefix, *args):
        for key in [k for k in state_dict
                    if any(k.startswith(prefix + n + ".") for n in names)]:
            del state_dict[key]
    return hook


class _BranchConvs(nn.Module):
    """``m`` dilated 3x3 conv -> BN -> ReLU branches, ``convs.{i}.{0,1}``."""

    def __init__(self, cin: int, cout: int, m: int, groups: int = 1, *,
                 generator: torch.Generator, device):
        super().__init__()
        self.convs = nn.ModuleList(nn.ModuleList([
            conv(cin, cout, 3, groups=groups, padding=1 + i,
                 dilation=1 + i, generator=generator, device=device),
            ChannelFirstBatchNorm(cout, device=device)]) for i in range(m))

    def branches(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [torch.relu(bn(cv(x))) for cv, bn in self.convs]


def _conv_bn(cin: int, cout: int, *, generator, device) -> nn.ModuleList:
    """A bias-free 1x1 conv and its BN, ``{0,1}`` (the reference's
    ``Sequential(Conv2d, BatchNorm2d, ...)``)."""
    return nn.ModuleList([conv(cin, cout, 1, generator=generator,
                               device=device),
                          ChannelFirstBatchNorm(cout, device=device)])


# ---------------------------------------------------------------------------
# SKNet.py: the branch-attention SKConv and its SKUnit
# ---------------------------------------------------------------------------

class SKConvSelective(_BranchConvs):
    """utils/SKNet.py:9-117 SKConv, ``pool_dim`` branch attention (M=4,
    r=4, the values SKNet.py:138 hard-codes).  ``hw``: the input's (H, W),
    which ``'freq'`` and ``'freq-time'`` size their ``fc`` by."""

    def __init__(self, cin: int, out_dim: int, pool_dim: str = "freq-chan",
                 m: int = 4, r: int = 4, hw=None, *,
                 generator: torch.Generator, device=None):
        super().__init__(cin, out_dim, m, generator=generator, device=device)
        self.pool_dim, self.m, self.out_dim = pool_dim, m, out_dim
        if pool_dim == "freq-chan":
            d, n = out_dim // r, out_dim
            mk = dict(ndim=1, k=1)
        elif pool_dim in ("freq", "freq-time"):
            n = hw[0] if pool_dim == "freq" else hw[0] * hw[1]
            d = n // r
            mk = None
        else:
            raise ValueError(f"pool_dim {pool_dim!r}")

        def layer(i, o):
            if mk is None:
                return linear(i, o, generator=generator, device=device)
            return conv(i, o, mk["k"], bias=True, ndim=mk["ndim"],
                        generator=generator, device=device)

        self.fc = nn.ModuleList([layer(n, d),
                                 ChannelFirstBatchNorm(d, device=device)])
        self.fcs = nn.ModuleList(layer(d, n) for _ in range(m))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        c, m = self.out_dim, self.m
        feats = torch.cat(self.branches(x), dim=1)
        feats = feats.reshape(b, m, h, c, w)           # view quirk 1
        feats_u = feats.sum(dim=1)                      # [B, H, C, W]
        fc, bn = self.fc
        if self.pool_dim == "freq-chan":
            s = feats_u.mean(dim=3).reshape(b, c, h)    # view quirk 2
            z = torch.relu(bn(fc(s)))                   # [B, d, H]
            att = torch.cat([f(z) for f in self.fcs], dim=1)
            att = torch.softmax(att.reshape(b, m, c, h, 1), dim=1)
            att = att.reshape(b, m, h, c, 1)            # view quirk 3
        elif self.pool_dim == "freq":
            z = torch.relu(bn(fc(feats_u.mean(dim=(2, 3)))))
            att = torch.stack([f(z) for f in self.fcs], dim=1)
            att = torch.softmax(att[..., None, None], dim=1)
        else:                                           # 'freq-time'
            z = torch.relu(bn(fc(feats_u.mean(dim=2).reshape(b, h * w))))
            att = torch.stack([f(z) for f in self.fcs], dim=1)
            att = torch.softmax(att[..., None, None], dim=1)
            att = att.reshape(b, m, h, 1, w)
        return (feats * att).sum(dim=1).transpose(1, 2)  # [B, C, H, W]


class SKUnitSelective(nn.Module):
    """utils/SKNet.py:119-173 SKUnit: 1x1 conv + BN + ReLU -> SKConv + BN +
    ReLU, as ``conv1.{0,1}`` and ``conv2_sk.{0,1}``.  The reference's
    ``conv3`` and ``shortcut`` weights are dead code (its forward returns
    after ``conv2_sk``): not held, and dropped from a loaded
    ``state_dict``."""

    def __init__(self, cin: int, mid: int, out: int,
                 pool_dim: str = "freq-chan", hw=None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.conv1 = _conv_bn(cin, mid, generator=generator, device=device)
        self.conv2_sk = nn.ModuleList([
            SKConvSelective(mid, out, pool_dim, hw=hw, generator=generator,
                            device=device),
            ChannelFirstBatchNorm(out, device=device)])
        self._register_load_state_dict_pre_hook(
            _drop_dead_keys(("conv3", "shortcut")))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cv, bn = self.conv1
        y = torch.relu(bn(cv(x)))
        sk, bn2 = self.conv2_sk
        return torch.relu(bn2(sk(y)))


# ---------------------------------------------------------------------------
# SKNet_v2.py and sknet_trans_*.py: channel + frequency attention
# ---------------------------------------------------------------------------

class _SKConvFused(_BranchConvs):
    """The branches, ``fc`` and ``fcs`` of SKNet_v2.py's SKConv and of
    sknet_trans_*.py's, and the two maps they fuse."""

    def __init__(self, cin: int, features: int, m: int, groups: int,
                 r: int, l_min: int, *, generator: torch.Generator, device):
        super().__init__(cin, features, m, groups, generator=generator,
                         device=device)
        d = max(features // r, l_min)
        self.fc = nn.ModuleList([
            conv(features, d, 1, generator=generator, device=device),
            ChannelFirstBatchNorm(d, device=device)])
        self.fcs = nn.ModuleList(
            conv(d, features, 1, bias=True, generator=generator,
                 device=device) for _ in range(m))

    def fused(self, x: torch.Tensor):
        """The channel-attended map (attention from the branch sum's
        pooled descriptor) and the frequency-attended one (attention from
        each branch's time-pooled channel sum)."""
        feats = torch.stack(self.branches(x), dim=1)   # [B, M, C, H, W]
        s = feats.sum(dim=1).mean(dim=(2, 3))          # [B, C]
        fc, bn = self.fc
        z = torch.relu(bn(F.linear(s, fc.weight.flatten(1))))
        att = torch.stack([F.linear(z, f.weight.flatten(1), f.bias)
                           for f in self.fcs], dim=1)
        att = torch.softmax(att, dim=1)                # [B, M, C]
        channel = (feats * att[..., None, None]).sum(dim=1)
        ff = feats.sum(dim=2).mean(dim=3, keepdim=True)  # [B, M, H, 1]
        freq = (feats * torch.softmax(ff, dim=1)[:, :, None]).sum(dim=1)
        return channel, freq


class SKConvV2(_SKConvFused):
    """utils/SKNet_v2.py:10-105: the channel- and frequency-attended maps,
    summed.  The reference's ``norm`` is never applied: not held, and
    dropped from a loaded ``state_dict``."""

    def __init__(self, cin: int, features: int, m: int = 2,
                 groups: int = 32, r: int = 16, l_min: int = 32, *,
                 generator: torch.Generator, device=None):
        super().__init__(cin, features, m, groups, r, l_min,
                         generator=generator, device=device)
        self._register_load_state_dict_pre_hook(_drop_dead_keys(("norm",)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        channel, freq = self.fused(x)
        return channel + freq


class SKUnitV2(nn.Module):
    """utils/SKNet_v2.py:107-173 SKUnit: 1x1 -> SKConvV2 -> 1x1, BN over
    the sum with the SKConv's output (``mid == out``).  The reference's
    ``shortcut`` is never applied: not held, and dropped on load."""

    def __init__(self, cin: int, mid: int, out: int, m: int = 2,
                 groups: int = 32, r: int = 16, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.conv1 = _conv_bn(cin, mid, generator=generator, device=device)
        self.conv2_sk = SKConvV2(mid, mid, m, groups, r, generator=generator,
                                 device=device)
        self.conv3 = _conv_bn(mid, out, generator=generator, device=device)
        self.norm = ChannelFirstBatchNorm(out, device=device)
        self._register_load_state_dict_pre_hook(
            _drop_dead_keys(("shortcut",)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cv, bn = self.conv1
        y = self.conv2_sk(torch.relu(bn(cv(x))))
        cv3, bn3 = self.conv3
        return torch.relu(self.norm(bn3(cv3(y)) + y))


class ReferenceChannelAttention(ChannelAttention):
    """``wpformer.ChannelAttention`` under the reference's names
    (``query1.{h}``, ``key.{h}``, ``value.{h}``, ``out1``: bias-free
    ``nn.Linear``, whose ``[out, in]`` weight is the port's matrix
    transposed)."""

    def __init__(self, channels: int, heads: int = 3, dropout: float = 0.1,
                 dropout_generator: torch.Generator | None = None, *,
                 generator: torch.Generator, device=None):
        nn.Module.__init__(self)
        self.channels, self.heads = channels, heads

        def lin():
            w = flax_param((channels, channels), "xavier_uniform", generator,
                           device)
            lin = nn.Linear(channels, channels, bias=False, device=device)
            with torch.no_grad():
                lin.weight.copy_(w.T)
            return lin

        for name in ("query1", "key", "value"):
            self.add_module(name, nn.ModuleList(lin() for _ in range(heads)))
        self.out1 = lin()
        self.attn_drop = TorchDropout(dropout, dropout_generator)
        self.proj_drop = TorchDropout(dropout, dropout_generator)

    def head_weights(self, w: str):
        if w == "wo":
            return self.out1.weight.t()
        heads = {"wq": self.query1, "wk": self.key, "wv": self.value}[w]
        return [lin.weight.t() for lin in heads]


class ReferenceChannelTransformer(ChannelTransformer):
    """``wpformer.ChannelTransformer`` under the reference's names
    (utils/ChanFreqTrans.py: ``embeddings_1``, ``encoder.layer.{l}``,
    ``encoder.encoder_norm1``, ``reconstruct_1``); the same computation,
    the same initializers."""

    def __init__(self, channels: int, spatial: Sequence[int],
                 num_layers: int = 1, heads: int = 3,
                 dropout_generator: torch.Generator | None = None, *,
                 generator: torch.Generator, device=None):
        nn.Module.__init__(self)
        self.channels, self.num_layers = channels, num_layers
        self.spatial = tuple(spatial)
        c, n = channels, self.spatial[0] * self.spatial[1]

        def drop():
            return TorchDropout(0.1, dropout_generator)

        self.embeddings_1 = nn.Module()
        self.embeddings_1.position_embeddings = flax_param(
            (1, n, c), "zeros", generator, device)
        self.embeddings_1.dropout = drop()
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList()
        for _ in range(num_layers):
            layer = nn.Module()
            layer.attn_norm1 = nn.LayerNorm(c, eps=1e-6, device=device)
            layer.channel_attn = ReferenceChannelAttention(
                c, heads, 0.1, dropout_generator, generator=generator,
                device=device)
            layer.ffn_norm1 = nn.LayerNorm(c, eps=1e-6, device=device)
            layer.ffn1 = nn.Module()
            layer.ffn1.fc1 = dense(c, 4 * c, generator, device)
            layer.ffn1.drop1 = drop()
            layer.ffn1.fc2 = dense(4 * c, c, generator, device)
            layer.ffn1.drop2 = drop()
            self.encoder.layer.append(layer)
        self.encoder.encoder_norm1 = nn.LayerNorm(c, eps=1e-6, device=device)
        self.reconstruct_1 = nn.Module()
        rec = nn.Conv2d(c, c, 1, device=device)
        with torch.no_grad():
            rec.weight.copy_(flax_param((1, 1, c, c), "he_normal", generator,
                                        device))
            rec.bias.zero_()
        self.reconstruct_1.conv = rec
        self.reconstruct_1.norm = TorchBatchNorm(c, device=device)

    def layer_parts(self, i: int):
        layer = self.encoder.layer[i]
        return (layer.attn_norm1, layer.channel_attn, layer.ffn_norm1,
                layer.ffn1.fc1, layer.ffn1.drop1, layer.ffn1.fc2,
                layer.ffn1.drop2)

    def outer_parts(self):
        rec = self.reconstruct_1
        return (self.embeddings_1.position_embeddings,
                self.embeddings_1.dropout, self.encoder.encoder_norm1,
                rec.conv.weight, rec.conv.bias, rec.norm)


class SKConvTrans(_SKConvFused):
    """sknet_trans_mmfi.py:10-113 SKConv: the V2 channel and frequency
    maps concatenated on the width axis, BN (``norm``), a 1-layer 3-head
    ChannelTransformer (``tf``) over the doubled-width map, then a (1, 2)
    average pool back to the input's width.  ``img_size``: (H, 2W)."""

    def __init__(self, cin: int, features: int, img_size: Sequence[int],
                 m: int = 2, groups: int = 32, r: int = 16, l_min: int = 32,
                 dropout_generator: torch.Generator | None = None, *,
                 generator: torch.Generator, device=None):
        super().__init__(cin, features, m, groups, r, l_min,
                         generator=generator, device=device)
        self.norm = ChannelFirstBatchNorm(features, device=device)
        self.tf = ReferenceChannelTransformer(
            features, img_size, 1, 3, dropout_generator,
            generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(torch.cat(self.fused(x), dim=3))
        # the transformer is channel-last; token order (h, w) is the
        # reference's NCHW flatten(2).transpose(-1, -2)
        y = self.tf(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return avg_pool_nchw(y, 1, 2)


class SKUnitTrans(nn.Module):
    """sknet_trans_mmfi.py:116-154 SKUnit (``pool=True``) /
    sknet_trans_wipose.py's, whose pool is commented out."""

    def __init__(self, cin: int, mid: int, out: int, img_size,
                 m: int = 2, groups: int = 32, r: int = 16,
                 pool: bool = True,
                 dropout_generator: torch.Generator | None = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.pool = pool
        self.conv1 = _conv_bn(cin, mid, generator=generator, device=device)
        self.conv2_sk = SKConvTrans(mid, mid, img_size, m, groups, r,
                                    dropout_generator=dropout_generator,
                                    generator=generator, device=device)
        self.norm = ChannelFirstBatchNorm(mid, device=device)
        self.conv3 = _conv_bn(mid, out, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cv, bn = self.conv1
        y = torch.relu(bn(cv(x)))
        if self.pool:
            y = avg_pool_nchw(y, 2, 2)
        y = self.norm(self.conv2_sk(y))
        cv3, bn3 = self.conv3
        return bn3(cv3(y))


# ---------------------------------------------------------------------------
# the pose models
# ---------------------------------------------------------------------------

class ReferenceLayout:
    """Mixin of the zoo's top-level models: ``spec()`` lists every weight
    (torch key, flax path, layouts); ``flax_variables(sd)`` is the JAX
    package's tree of a ``state_dict`` (``train/loop.py`` writes it as
    ``best_pose_model.msgpack``); ``load_jax_variables(v)`` loads a JAX
    tree."""

    def spec(self) -> List[Spec]:
        raise NotImplementedError

    def flax_variables(self, state_dict: Mapping[str, Any]):
        return variables_from_spec(state_dict, self.spec())

    def load_jax_variables(self, variables: Mapping[str, Any]):
        from wiflow_tpu_torch.models.torch_compat import load_state_dict
        return load_state_dict(self, state_dict_from_spec(variables,
                                                          self.spec()))


class _ZooModel(ReferenceLayout, nn.Module):
    """Built on ``device`` (CUDA unless ``"cpu"``) in eval mode, its
    weights drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
    when None), its dropout masks from ``dropout_generator`` (on the
    device)."""

    def _setup(self, device, generator):
        nn.Module.__init__(self)
        dev = resolve_device(device)
        self.dropout_generator = torch.Generator(device=dev)
        return dev, generator or torch.Generator().manual_seed(0)

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        """The input in the parameters' dtype: fp32, as the JAX module
        casts it (float64 once the module is ``.double()``)."""
        return x.to(self.regression.fc1.weight.dtype)

    def _head(self, n_in: int, n_out: int, gen, dev) -> RegressionHead:
        return RegressionHead(n_in, n_out, 32, self.dropout_generator,
                              generator=gen, device=dev)


class OriginalHPE(_ZooModel):
    """HPE_no_denoiser.py:9-73, the MM-Fi HPE-Li model: ``[B, 3, 114, 10]``
    -> SKUnit(3->64) -> AvgPool2 -> SKUnit(64->128) -> AvgPool2 ->
    regression(7168->34) -> ``[B, 17, 2]``."""

    def __init__(self, num_keypoints: int = 17, *, device=None,
                 generator: torch.Generator | None = None):
        dev, gen = self._setup(device, generator)
        self.num_keypoints = num_keypoints
        self.skunit1 = SKUnitSelective(3, 64, 64, generator=gen, device=dev)
        self.skunit2 = SKUnitSelective(64, 128, 128, generator=gen,
                                       device=dev)
        self.regression = self._head(128 * 28 * 2, num_keypoints * 2, gen,
                                     dev)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = avg_pool_nchw(self.skunit1(self._input(x)), 2, 2)
        x = avg_pool_nchw(self.skunit2(x), 2, 2)
        return self.regression(x).reshape(b, self.num_keypoints, 2)

    def spec(self) -> List[Spec]:
        return original_hpe_spec()


class HPEWiPoseModel(_ZooModel):
    """HPE_Wipose.py:9-100: ``[B, 9, 30, 5]`` -> SKUnit(9->64) -> AvgPool2
    -> SKUnit(64->128) -> AvgPool2 -> SKUnit(128->256) ->
    regression(1792->36) -> ``[B, 18, 2]`` (the reference builds a
    ``skunit4`` its forward never uses; not held)."""

    def __init__(self, *, device=None,
                 generator: torch.Generator | None = None):
        dev, gen = self._setup(device, generator)
        self.skunit1 = SKUnitSelective(9, 64, 64, generator=gen, device=dev)
        self.skunit2 = SKUnitSelective(64, 128, 128, generator=gen,
                                       device=dev)
        self.skunit3 = SKUnitSelective(128, 256, 256, generator=gen,
                                       device=dev)
        self.regression = self._head(256 * 7 * 1, 36, gen, dev)
        self._register_load_state_dict_pre_hook(
            _drop_dead_keys(("skunit4",)))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = avg_pool_nchw(self.skunit1(self._input(x)), 2, 2)
        x = avg_pool_nchw(self.skunit2(x), 2, 2)
        return self.regression(self.skunit3(x)).reshape(b, 18, 2)

    def spec(self) -> List[Spec]:
        return hpe_wipose_spec()


class BasicCnnHPE(_ZooModel):
    """HPE_basic_cnn.py:9-50: ``[B, 3, 114, 10]`` -> Conv2d(3->64, k7,
    valid) -> AvgPool2 -> BN -> ReLU -> AvgPool2 -> regression(1728->34)
    -> ``[B, 17, 2]``."""

    def __init__(self, *, device=None,
                 generator: torch.Generator | None = None):
        dev, gen = self._setup(device, generator)
        self.CNN1 = conv(3, 64, 7, bias=True, generator=gen, device=dev)
        self.bn = ChannelFirstBatchNorm(64, device=dev)
        self.regression = self._head(64 * 27 * 1, 34, gen, dev)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = avg_pool_nchw(self.CNN1(self._input(x)), 2, 2)
        x = avg_pool_nchw(torch.relu(self.bn(x)), 2, 2)
        return self.regression(x).reshape(b, 17, 2)

    def spec(self) -> List[Spec]:
        return basic_cnn_spec()


class _DSKNetTransZoo(_ZooModel):
    """SKUnitTrans -> BN -> [AvgPool2] -> SKUnitTrans -> [AvgPool2] ->
    regression."""

    def _build(self, cin, widths, imgs, m, groups, pool, n_flat, n_out,
               dev, gen):
        (m1, m2), (i1, i2) = widths, imgs
        kw = dict(m=m, groups=groups, r=4, pool=pool,
                  dropout_generator=self.dropout_generator, generator=gen,
                  device=dev)
        self.skunit1 = SKUnitTrans(cin, m1, m1, i1, **kw)
        self.norm = ChannelFirstBatchNorm(m1, device=dev)
        self.skunit2 = SKUnitTrans(m1, m2, m2, i2, **kw)
        self.regression = self._head(n_flat, n_out, gen, dev)
        self.eval()


class DSKNetTransMMFi(_DSKNetTransZoo):
    """sknet_trans_mmfi.py:156-207 DSKNetTransMMFI: ``[B, 3, 114, 10]`` ->
    SKUnitTrans(3->128, pool) -> BN -> SKUnitTrans(128->256, pool) ->
    AvgPool2 -> regression(3584->34) -> ``[B, 17, 2]``."""

    def __init__(self, *, device=None,
                 generator: torch.Generator | None = None):
        dev, gen = self._setup(device, generator)
        self._build(3, (128, 256), ((57, 10), (28, 4)), 3, 32, True,
                    256 * 14 * 1, 34, dev, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.skunit2(self.norm(self.skunit1(self._input(x))))
        return self.regression(avg_pool_nchw(x, 2, 2)).reshape(b, 17, 2)

    def spec(self) -> List[Spec]:
        return dsknet_trans_mmfi_spec()


class DSKNetTransWipose(_DSKNetTransZoo):
    """sknet_trans_wipose.py:156-205 DSKNetTransWipose: ``[B, 9, 30, 5]``
    -> SKUnitTrans(9->64) -> BN -> AvgPool2 -> SKUnitTrans(64->128) ->
    regression(3840->36) -> ``[B, 18, 2]``."""

    def __init__(self, *, device=None,
                 generator: torch.Generator | None = None):
        dev, gen = self._setup(device, generator)
        self._build(9, (64, 128), ((30, 10), (15, 4)), 2, 64, False,
                    128 * 15 * 2, 36, dev, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = avg_pool_nchw(self.norm(self.skunit1(self._input(x))), 2, 2)
        return self.regression(self.skunit2(x)).reshape(b, 18, 2)

    def spec(self) -> List[Spec]:
        return dsknet_trans_wipose_spec()


# ---------------------------------------------------------------------------
# the specs (a copy of the JAX module's, hpeli_zoo.py:524-689) and the
# conversion they drive
# ---------------------------------------------------------------------------

def _ident(w):
    return w


def _t(w):
    return w.T


def _sq1(w):                 # Conv1d k=1 [out, in, 1] -> [out, in]
    return w[:, :, 0]


def _sq1_inv(w):
    return w[:, :, None]


def _sq2(w):                 # Conv2d 1x1 [out, in, 1, 1] -> [out, in]
    return w[:, :, 0, 0]


def _sq2_inv(w):
    return w[:, :, None, None]


def _hwio(w):                # OIHW -> HWIO
    return w.transpose(2, 3, 1, 0)


def _hwio_inv(w):
    return w.transpose(3, 2, 0, 1)


def bn_specs(tp: str, fp: Path) -> List[Spec]:
    """A BatchNorm's four entries."""
    return [(f"{tp}.weight", "params", fp + ("weight",), _ident, _ident),
            (f"{tp}.bias", "params", fp + ("bias",), _ident, _ident),
            (f"{tp}.running_mean", "batch_stats", fp + ("running_mean",),
             _ident, _ident),
            (f"{tp}.running_var", "batch_stats", fp + ("running_var",),
             _ident, _ident)]


def regression_spec(tp: str, fp: Path) -> List[Spec]:
    """utils/regression.py regression -> RegressionHead."""
    s: List[Spec] = []
    for fc in ("fc1", "fc2", "fc3"):
        s.append((f"{tp}.{fc}.weight", "params", fp + (fc, "kernel"), _t, _t))
        s.append((f"{tp}.{fc}.bias", "params", fp + (fc, "bias"),
                  _ident, _ident))
    return s + bn_specs(f"{tp}.bn", fp + ("bn",))


def _branch_specs(tp: str, fp: Path, m: int) -> List[Spec]:
    s: List[Spec] = []
    for i in range(m):
        s.append((f"{tp}.convs.{i}.0.weight", "params",
                  fp + ("branches", f"convs_{i}_weight"), _ident, _ident))
        s += bn_specs(f"{tp}.convs.{i}.1",
                      fp + ("branches", f"convs_{i}_bn"))
    return s


def sk_unit_selective_spec(tp: str, fp: Path, m: int = 4,
                           pool_dim: str = "freq-chan") -> List[Spec]:
    """utils/SKNet.py SKUnit.  ``conv3``/``shortcut`` are dead code in the
    reference forward and unmapped.  The ``fc`` layers are Conv1d under
    'freq-chan' and ``nn.Linear`` under 'freq' / 'freq-time'."""
    sq, sq_inv = (_sq1, _sq1_inv) if pool_dim == "freq-chan" else (_ident,
                                                                   _ident)
    s: List[Spec] = [(f"{tp}.conv1.0.weight", "params",
                      fp + ("conv1_weight",), _ident, _ident)]
    s += bn_specs(f"{tp}.conv1.1", fp + ("conv1_bn",))
    sk = f"{tp}.conv2_sk.0"
    s += _branch_specs(sk, fp + ("sk",), m)
    s.append((f"{sk}.fc.0.weight", "params", fp + ("sk", "fc_weight"),
              sq, sq_inv))
    s.append((f"{sk}.fc.0.bias", "params", fp + ("sk", "fc_bias"),
              _ident, _ident))
    s += bn_specs(f"{sk}.fc.1", fp + ("sk", "fc_bn"))
    for i in range(m):
        s.append((f"{sk}.fcs.{i}.weight", "params",
                  fp + ("sk", f"fcs_{i}_weight"), sq, sq_inv))
        s.append((f"{sk}.fcs.{i}.bias", "params",
                  fp + ("sk", f"fcs_{i}_bias"), _ident, _ident))
    return s + bn_specs(f"{tp}.conv2_sk.1", fp + ("sk_bn",))


def original_hpe_spec() -> List[Spec]:
    return (sk_unit_selective_spec("skunit1", ("skunit1",))
            + sk_unit_selective_spec("skunit2", ("skunit2",))
            + regression_spec("regression", ("regression",)))


def hpe_wipose_spec() -> List[Spec]:
    return (sk_unit_selective_spec("skunit1", ("skunit1",))
            + sk_unit_selective_spec("skunit2", ("skunit2",))
            + sk_unit_selective_spec("skunit3", ("skunit3",))
            + regression_spec("regression", ("regression",)))


def basic_cnn_spec() -> List[Spec]:
    return ([("CNN1.weight", "params", ("cnn1_weight",), _ident, _ident),
             ("CNN1.bias", "params", ("cnn1_bias",), _ident, _ident)]
            + bn_specs("bn", ("bn",))
            + regression_spec("regression", ("regression",)))


def sk_conv_v2_spec(tp: str, fp: Path, m: int = 2) -> List[Spec]:
    """utils/SKNet_v2.py SKConv (its unused ``norm`` BN is unmapped)."""
    s = _branch_specs(tp, fp, m)
    s.append((f"{tp}.fc.0.weight", "params", fp + ("fc_weight",),
              _sq2, _sq2_inv))
    s += bn_specs(f"{tp}.fc.1", fp + ("fc_bn",))
    for i in range(m):
        s.append((f"{tp}.fcs.{i}.weight", "params",
                  fp + (f"fcs_{i}_weight",), _sq2, _sq2_inv))
        s.append((f"{tp}.fcs.{i}.bias", "params",
                  fp + (f"fcs_{i}_bias",), _ident, _ident))
    return s


def sk_unit_v2_spec(tp: str, fp: Path, m: int = 2) -> List[Spec]:
    s: List[Spec] = [(f"{tp}.conv1.0.weight", "params",
                      fp + ("conv1_weight",), _ident, _ident)]
    s += bn_specs(f"{tp}.conv1.1", fp + ("conv1_bn",))
    s += sk_conv_v2_spec(f"{tp}.conv2_sk", fp + ("sk",), m)
    s.append((f"{tp}.conv3.0.weight", "params", fp + ("conv3_weight",),
              _ident, _ident))
    s += bn_specs(f"{tp}.conv3.1", fp + ("conv3_bn",))
    return s + bn_specs(f"{tp}.norm", fp + ("norm",))


def channel_transformer_spec(tp: str, fp: Path, num_layers: int = 1,
                             heads: int = 3) -> List[Spec]:
    """utils/ChanFreqTrans.py ChannelTransformer -> wpformer's flax one."""
    s: List[Spec] = [(f"{tp}.embeddings_1.position_embeddings", "params",
                      fp + ("position_embeddings",), _ident, _ident)]
    for l in range(num_layers):
        lt = f"{tp}.encoder.layer.{l}"
        s += [(f"{lt}.attn_norm1.weight", "params",
               fp + (f"attn_norm_{l}", "scale"), _ident, _ident),
              (f"{lt}.attn_norm1.bias", "params",
               fp + (f"attn_norm_{l}", "bias"), _ident, _ident)]
        for h in range(heads):
            for tname, fname in (("query1", "wq"), ("key", "wk"),
                                 ("value", "wv")):
                s.append((f"{lt}.channel_attn.{tname}.{h}.weight", "params",
                          fp + (f"attn_{l}", f"{fname}{h}"), _t, _t))
        s.append((f"{lt}.channel_attn.out1.weight", "params",
                  fp + (f"attn_{l}", "wo"), _t, _t))
        s += [(f"{lt}.ffn_norm1.weight", "params",
               fp + (f"ffn_norm_{l}", "scale"), _ident, _ident),
              (f"{lt}.ffn_norm1.bias", "params",
               fp + (f"ffn_norm_{l}", "bias"), _ident, _ident)]
        for tname, fname in (("fc1", f"mlp_in_{l}"), ("fc2", f"mlp_out_{l}")):
            s.append((f"{lt}.ffn1.{tname}.weight", "params",
                      fp + (fname, "kernel"), _t, _t))
            s.append((f"{lt}.ffn1.{tname}.bias", "params",
                      fp + (fname, "bias"), _ident, _ident))
    s += [(f"{tp}.encoder.encoder_norm1.weight", "params",
           fp + ("encoder_norm", "scale"), _ident, _ident),
          (f"{tp}.encoder.encoder_norm1.bias", "params",
           fp + ("encoder_norm", "bias"), _ident, _ident)]
    s.append((f"{tp}.reconstruct_1.conv.weight", "params",
              fp + ("rec_weight",), _hwio, _hwio_inv))
    s.append((f"{tp}.reconstruct_1.conv.bias", "params",
              fp + ("rec_bias",), _ident, _ident))
    return s + bn_specs(f"{tp}.reconstruct_1.norm", fp + ("rec_bn",))


def sk_unit_trans_spec(tp: str, fp: Path, m: int) -> List[Spec]:
    s: List[Spec] = [(f"{tp}.conv1.0.weight", "params",
                      fp + ("conv1_weight",), _ident, _ident)]
    s += bn_specs(f"{tp}.conv1.1", fp + ("conv1_bn",))
    sk = f"{tp}.conv2_sk"
    s += _branch_specs(sk, fp + ("sk",), m)
    s.append((f"{sk}.fc.0.weight", "params", fp + ("sk", "fc_weight"),
              _sq2, _sq2_inv))
    s += bn_specs(f"{sk}.fc.1", fp + ("sk", "fc_bn"))
    for i in range(m):
        s.append((f"{sk}.fcs.{i}.weight", "params",
                  fp + ("sk", f"fcs_{i}_weight"), _sq2, _sq2_inv))
        s.append((f"{sk}.fcs.{i}.bias", "params",
                  fp + ("sk", f"fcs_{i}_bias"), _ident, _ident))
    s += bn_specs(f"{sk}.norm", fp + ("sk", "norm"))
    s += channel_transformer_spec(f"{sk}.tf", fp + ("sk", "tf"))
    s += bn_specs(f"{tp}.norm", fp + ("norm",))
    s.append((f"{tp}.conv3.0.weight", "params", fp + ("conv3_weight",),
              _ident, _ident))
    return s + bn_specs(f"{tp}.conv3.1", fp + ("conv3_bn",))


def dsknet_trans_mmfi_spec() -> List[Spec]:
    return (sk_unit_trans_spec("skunit1", ("skunit1",), m=3)
            + sk_unit_trans_spec("skunit2", ("skunit2",), m=3)
            + bn_specs("norm", ("norm",))
            + regression_spec("regression", ("regression",)))


def dsknet_trans_wipose_spec() -> List[Spec]:
    return (sk_unit_trans_spec("skunit1", ("skunit1",), m=2)
            + sk_unit_trans_spec("skunit2", ("skunit2",), m=2)
            + bn_specs("norm", ("norm",))
            + regression_spec("regression", ("regression",)))


def _spec_of(spec_or_model) -> List[Spec]:
    return (spec_or_model.spec() if hasattr(spec_or_model, "spec")
            else spec_or_model)


def state_dict_from_spec(variables: Mapping[str, Any], spec_or_model
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{'params', 'batch_stats'}`` tree (numpy arrays,
    or anything ``np.asarray`` takes) -> the port's ``state_dict`` under the
    reference's names, by a spec (or a module's ``spec()``): float32 CPU
    tensors, bit for bit.  A leaf missing from the tree raises
    ``KeyError`` naming its path."""
    out: Dict[str, torch.Tensor] = {}
    for torch_key, coll, path, _, inv in _spec_of(spec_or_model):
        node = variables[coll]
        try:
            for p in path:
                node = node[p]
        except KeyError:
            raise KeyError(f"JAX variables lack {coll}/{'/'.join(path)} "
                           f"(torch key {torch_key})") from None
        a = np.ascontiguousarray(inv(np.asarray(node, np.float32)))
        out[torch_key] = torch.from_numpy(a.copy())
    return out


def variables_from_spec(state_dict: Mapping[str, Any], spec_or_model
                        ) -> Dict[str, Dict[str, Any]]:
    """The inverse of :func:`state_dict_from_spec`: a ``state_dict`` under
    the reference's names -> the JAX tree of float32 numpy arrays (keys
    outside the spec, ``num_batches_tracked``, are left out; a missing key
    raises ``KeyError`` naming it)."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for torch_key, coll, path, fwd, _ in _spec_of(spec_or_model):
        if torch_key not in state_dict:
            raise KeyError(f"state_dict lacks {torch_key} "
                           f"(JAX {coll}/{'/'.join(path)})")
        v = state_dict[torch_key]
        a = (v.detach().cpu().numpy() if torch.is_tensor(v)
             else np.asarray(v)).astype(np.float32)
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(fwd(a))
    return out
