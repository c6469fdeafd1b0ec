"""Plain PyTorch layers of the reference, and the dispatch to each
configuration's own reference module.

The layers are written from the published WiFlow model
(``models/tcn.py``, ``models/convnet.py``, ``models/attention.py`` of the
WiFlow repository) as plain functions over a ``state_dict`` under the
published torch names.  No kernels, no folding, no batching tricks: every
convolution is a ``torch.nn.functional`` call, every BatchNorm is applied
as written, the attention's logits are formed whole and normalised by
their BatchNorm before the softmax.  It imports nothing of the measured
program.  A configuration file names its reference module under
``reference`` (``benchmark/reference/<name>.py``), which lays out the
model's parameters and assembles its forward from these layers
(:mod:`benchmark.reference.wiflow`, :mod:`benchmark.reference.wiflow_mmfi`).

It runs in float32 (the caller turns TF32 off).  ``q`` is applied to the
input, every weight and every op's output; :func:`fp32` leaves them, and
:func:`fp8` rounds them to float8 e4m3, which is the lower-precision
control that the benchmark's comparisons must tell apart.

In train mode BatchNorm normalises with the batch's statistics and the
dropout masks are drawn from ``gen`` in the module's order, with the
shapes the program draws them in: one bit an element of a TCN level's
activation ``[B, T, C]``, one bit a (sample, channel) of a conv block's
``[B, 1, 1, C]``.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.1     # BatchNorm's running statistics, torch's default
Tensor = torch.Tensor


def fp32(x: Tensor) -> Tensor:
    return x


def fp8(x: Tensor) -> Tensor:
    """Round to float8 e4m3 (saturating at its largest value, 448)."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)


# --- the parameter layout ------------------------------------------------

def bn_spec(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,), "bn_weight"),
            (f"{prefix}.bias", (c,), "bn_bias"),
            (f"{prefix}.running_mean", (c,), "running_mean"),
            (f"{prefix}.running_var", (c,), "running_var"),
            (f"{prefix}.num_batches_tracked", (), "count")]


def tcn_spec(cfg: Mapping, cin: int):
    out, g, k = [], cfg["tcn_groups"], cfg["tcn_kernel_size"]
    for i, cout in enumerate(cfg["tcn_channels"]):
        p = f"tcn.network.{i}"
        out += [(f"{p}.conv1_group.weight", (cin, cin // g, k), "conv1d")]
        out += bn_spec(f"{p}.bn1_group", cin)
        out += [(f"{p}.conv1_pw.weight", (cout, cin, 1), "conv1d")]
        out += bn_spec(f"{p}.bn1_pw", cout)
        out += [(f"{p}.conv2_group.weight", (cout, cout // g, k), "conv1d")]
        out += bn_spec(f"{p}.bn2_group", cout)
        out += [(f"{p}.conv2_pw.weight", (cout, cout, 1), "conv1d")]
        out += bn_spec(f"{p}.bn2_pw", cout)
        if cin != cout:
            out += [(f"{p}.downsample.0.weight", (cout, cin, 1), "conv1d")]
            out += bn_spec(f"{p}.downsample.1", cout)
        cin = cout
    return out


def conv_spec(cfg: Mapping):
    out, ci = [], 1
    chans = (cfg["conv_channels"][0],) + tuple(cfg["conv_channels"])
    names = ["up"] + [f"residual_blocks.{j}"
                      for j in range(len(cfg["conv_channels"]))]
    for p, co in zip(names, chans):
        for i, c_in in ((0, ci), (4, co), (8, co)):
            out += [(f"{p}.block.{i}.weight", (co, c_in, 1, 3), "conv2d"),
                    (f"{p}.block.{i}.bias", (co,), "conv2d_bias")]
            out += bn_spec(f"{p}.block.{i + 1}", co)
        out += [(f"{p}.downsample.0.weight", (co, ci, 1, 1), "conv2d")]
        out += bn_spec(f"{p}.downsample.1", co)
        ci = co
    return out


def attention_spec(prefix: str, c: int, g: int):
    out = []
    for axis in ("width_axis", "height_axis"):
        p = f"{prefix}.{axis}"
        out += [(f"{p}.qkv_transform.weight", (3 * c, c, 1), "conv1d")]
        out += bn_spec(f"{p}.bn_qkv", 3 * c)
        out += bn_spec(f"{p}.bn_similarity", g)
        out += bn_spec(f"{p}.bn_output", c)
    return out


def family(cfg: Mapping):
    """The configuration's own reference module,
    ``benchmark/reference/<cfg["reference"]>.py``: its parameter layout
    (``spec``), input shape, forward, loss and analytic FLOPs."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def spec(cfg: Mapping) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and buffer, in the module's
    order.  Kinds: ``conv1d`` (kaiming-normal fan-out init), ``conv2d`` /
    ``conv2d_bias`` (uniform 1/sqrt(fan_in)), ``bn_weight``, ``bn_bias``,
    ``running_mean``, ``running_var``, ``count``."""
    return family(cfg).spec(cfg)


def input_shape(cfg: Mapping) -> tuple:
    """One sample's input."""
    return tuple(family(cfg).input_shape(cfg))


def input_running_mean(cfg: Mapping) -> str:
    """The running mean of the BatchNorm that reads the input: the first
    in the module's order."""
    return next(n for n, _, kind in spec(cfg) if kind == "running_mean")


def parameter_names(cfg: Mapping) -> List[str]:
    """The trainable entries of :func:`spec` (weights and biases)."""
    return [n for n, _, kind in spec(cfg)
            if kind not in ("running_mean", "running_var", "count")]


# --- the forward ----------------------------------------------------------

class Run:
    """One forward's mode: weights ``p``, rounding ``q``, train mode, the
    dropout generator and rates, and ``stats``, where a train-mode forward
    leaves each BatchNorm's batch mean, biased variance and count of
    elements a channel by name."""

    def __init__(self, p: Mapping[str, Tensor], q: Callable = fp32,
                 train: bool = False, gen: Optional[torch.Generator] = None,
                 rates: Tuple[float, float] = (0.0, 0.0),
                 stats: Optional[Dict[str, Tuple[Tensor, Tensor, int]]]
                 = None):
        self.p, self.q, self.train, self.gen = p, q, train, gen
        self.rate, self.rate2d = rates
        self.stats = stats

    def w(self, name: str) -> Tensor:
        return self.q(self.p[name])

    def bn(self, x: Tensor, prefix: str, axis: int = -1) -> Tensor:
        """BatchNorm over ``axis`` (the channels)."""
        xm = x.movedim(axis, -1)
        if self.train:
            dims = tuple(range(xm.ndim - 1))
            mean = xm.mean(dim=dims)
            var = xm.var(dim=dims, unbiased=False)
            if self.stats is not None:
                self.stats[prefix] = (mean.detach(), var.detach(),
                                      xm.numel() // xm.shape[-1])
        else:
            mean = self.p[f"{prefix}.running_mean"]
            var = self.p[f"{prefix}.running_var"]
        y = ((xm - mean) / torch.sqrt(var + EPS) * self.w(f"{prefix}.weight")
             + self.w(f"{prefix}.bias"))
        return self.q(y.movedim(-1, axis))

    def silu(self, x: Tensor) -> Tensor:
        return self.q(x * torch.sigmoid(x))

    def dropout(self, x: Tensor) -> Tensor:
        """Elementwise dropout on ``[B, T, C]``."""
        if not self.train or self.rate <= 0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.gen, device=x.device) < keep
        return self.q(torch.where(mask, x / keep, 0.0))

    def dropout2d(self, x: Tensor) -> Tensor:
        """Channel dropout on ``[B, H, W, C]``: a bit a (sample, channel)."""
        if not self.train or self.rate2d <= 0:
            return x
        keep = 1.0 - self.rate2d
        b, c = x.shape[0], x.shape[-1]
        mask = torch.rand((b, 1, 1, c), generator=self.gen,
                          device=x.device) < keep
        return self.q(torch.where(mask, x / keep, 0.0))


def conv1d(r: Run, x: Tensor, name: str, *, dilation: int = 1,
            groups: int = 1, causal: bool = False) -> Tensor:
    """Conv1d on channel-last ``[B, T, C]``; causal: left-padded by
    (K - 1) x dilation (the reference's Conv1d + Chomp1d)."""
    w = r.w(name)
    xc = x.transpose(1, 2)
    if causal:
        xc = F.pad(xc, ((w.shape[-1] - 1) * dilation, 0))
    return r.q(F.conv1d(xc, w, dilation=dilation, groups=groups)
               .transpose(1, 2))


def conv2d(r: Run, x: Tensor, name: str, *, stride: int = 1,
            padding=0, bias: bool = True) -> Tensor:
    """Conv2d on channel-last ``[B, H, W, C]``, stride along W."""
    b = r.w(name.replace(".weight", ".bias")) if bias else None
    y = F.conv2d(x.permute(0, 3, 1, 2), r.w(name), b, stride=(1, stride),
                 padding=padding)
    return r.q(y.permute(0, 2, 3, 1))


def tcn(r: Run, x: Tensor, cfg: Mapping) -> Tensor:
    """The dilated grouped TCN on ``[B, T, C]`` (ref models/tcn.py)."""
    g, cin = cfg["tcn_groups"], x.shape[-1]
    for i, cout in enumerate(cfg["tcn_channels"]):
        p, d = f"tcn.network.{i}", 2 ** i
        res = x
        if cin != cout:
            res = r.bn(conv1d(r, x, f"{p}.downsample.0.weight"),
                       f"{p}.downsample.1")
        h = conv1d(r, x, f"{p}.conv1_group.weight", dilation=d, groups=g,
                    causal=True)
        h = r.silu(r.bn(h, f"{p}.bn1_group"))
        h = r.dropout(r.silu(r.bn(conv1d(r, h, f"{p}.conv1_pw.weight"),
                                  f"{p}.bn1_pw")))
        h = conv1d(r, h, f"{p}.conv2_group.weight", dilation=d, groups=g,
                    causal=True)
        h = r.silu(r.bn(h, f"{p}.bn2_group"))
        h = r.dropout(r.silu(r.bn(conv1d(r, h, f"{p}.conv2_pw.weight"),
                                  f"{p}.bn2_pw")))
        x = r.silu(h + res)
        cin = cout
    return x


def conv_stack(r: Run, x: Tensor, cfg: Mapping) -> Tensor:
    """``up`` and the stride-2 residual blocks of (1, 3) convs on
    ``[B, T, W, C]`` (ref models/convnet.py)."""
    names = ["up"] + [f"residual_blocks.{j}"
                      for j in range(len(cfg["conv_channels"]))]
    for k, p in enumerate(names):
        s = 1 if k == 0 else 2
        identity = r.bn(conv2d(r, x[:, :, ::s], f"{p}.downsample.0.weight",
                                bias=False), f"{p}.downsample.1")
        h = x
        for i, stride in ((0, s), (4, 1), (8, 1)):
            h = r.bn(conv2d(r, h, f"{p}.block.{i}.weight", stride=stride,
                             padding=(0, 1)), f"{p}.block.{i + 1}")
            if i < 8:
                h = r.dropout2d(r.silu(h))
        x = r.silu(h + identity)
    return x


def _axis(r: Run, x: Tensor, prefix: str, groups: int, width: bool) -> Tensor:
    """Grouped attention along W (``width``) or H of ``[B, H, W, C]``, with
    BatchNorm on the QKV projection, on the logits and on the output
    (ref models/attention.py)."""
    b, h, w, c = x.shape
    xr = x.reshape(b * h, w, c) if width else \
        x.transpose(1, 2).reshape(b * w, h, c)
    n, length, _ = xr.shape
    gp = c // groups
    qkv = r.bn(conv1d(r, xr, f"{prefix}.qkv_transform.weight"),
               f"{prefix}.bn_qkv")
    q, k, v = (t.reshape(n, length, groups, gp)
               for t in torch.split(qkv, c, dim=-1))
    logits = r.q(torch.einsum("bigc,bjgc->bgij", q, k))
    sim = torch.softmax(r.bn(logits, f"{prefix}.bn_similarity", axis=1),
                        dim=-1)
    out = r.q(torch.einsum("bgij,bjgc->bigc", r.q(sim), v))
    out = r.bn(out.reshape(n, length, c), f"{prefix}.bn_output")
    if width:
        return out.reshape(b, h, w, c)
    return out.reshape(b, w, h, c).transpose(1, 2)


def attention(r: Run, x: Tensor, prefix: str, groups: int) -> Tensor:
    x = _axis(r, x, f"{prefix}.width_axis", groups, True)
    return _axis(r, x, f"{prefix}.height_axis", groups, False)


def forward(r: Run, x: Tensor, cfg: Mapping) -> Tensor:
    """The configuration's forward of the batch ``x`` in the mode ``r``."""
    return family(cfg).forward(r, x, cfg)


@torch.no_grad()
def serve(p: Mapping[str, Tensor], x: Tensor, cfg: Mapping,
          q: Callable = fp32, block: int = 4096) -> Tensor:
    """Eval-mode forward of ``x`` in blocks of ``block`` rows."""
    r = Run(p, q)
    return torch.cat([forward(r, x[i:i + block], cfg)
                      for i in range(0, x.shape[0], block)])


def dropout_rates(cfg: Mapping) -> Tuple[float, float]:
    return cfg["dropout"], cfg["conv_dropout"]


def state(sd: Mapping[str, Tensor], device) -> Dict[str, Tensor]:
    """``sd`` as float32 tensors on ``device`` (counters dropped)."""
    return {k: v.to(device=device, dtype=torch.float32)
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}
