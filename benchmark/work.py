"""Operations and bytes of each measured op, from a configuration's shapes.

The yardstick of every roofline and MFU metric.  Nothing here reads the
program: the work of an op is worked out from the layer shapes of the
configuration file (``configs/<name>.json``), so it stays the same
whatever implements the op or however its launches are planned.

Conventions (as in the port's ``chip_smoke.py``, whose ``tcn_work``,
``conv_work``, ``attention_work``, ``stage_work``, ``join_work`` and
``train_work`` these functions copy):

* a multiply-add counts 2 FLOPs;
* bytes: each input read once and each output written once, in the
  compute dtype's element size ``esize``, vectors in fp32;
* the bound of an op is the larger of FLOPs over the peak FLOP/s and
  bytes over the peak bytes/s of the card.

Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ESIZE = {"bfloat16": 2, "float32": 4}

Work = Tuple[float, float]          # (FLOPs, bytes)


def bound_s(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """Least seconds the card could take, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def input_channels(cfg: Mapping) -> int:
    """Channels the TCN reads: MM-Fi flattens its antennas into them."""
    return cfg.get("num_antennas", 1) * cfg["num_subcarriers"]


def conv_width(cfg: Mapping) -> int:
    """The conv stack's input width: the TCN's last width or, for MM-Fi,
    the projection's."""
    return cfg.get("tcn_proj_channels", cfg["tcn_channels"][-1])


def tcn(cfg: Mapping, batch: int, esize: int) -> Work:
    """The TCN levels of one forward over ``batch`` samples."""
    t, g = cfg["window_size"], cfg["tcn_groups"]
    k = cfg["tcn_kernel_size"]
    flops = nbytes = 0
    cin = input_channels(cfg)
    for cout in cfg["tcn_channels"]:
        ds = cin * cout if cin != cout else 0
        weights = (k * cin * (cin // g) + cin * cout + k * cout * (cout // g)
                   + cout * cout + ds)
        flops += 2 * batch * t * weights
        nbytes += (batch * t * (cin + cout) * esize + weights * esize
                   + 4 * (cin + 3 * cout + (cout if ds else 0)))
        cin = cout
    return flops, nbytes


def _conv_blocks(cfg: Mapping):
    """(c_in, c_out, w_in, w_out) of ``up`` and each stride-2 block."""
    w, ci = conv_width(cfg), 1
    chans = (cfg["conv_channels"][0],) + tuple(cfg["conv_channels"])
    out = []
    for j, co in enumerate(chans):
        wout = w if j == 0 else (w - 1) // 2 + 1
        out.append((ci, co, w, wout))
        ci, w = co, wout
    return out


def conv_stack(cfg: Mapping, rows: int, esize: int) -> Work:
    """The (1, 3) conv stack over ``rows`` rows (samples x time steps)."""
    macs = weights = 0
    blocks = _conv_blocks(cfg)
    for ci, co, _, wout in blocks:
        macs += 3 * ci * co * wout + 2 * 3 * co * co * wout + ci * co * wout
        weights += 3 * ci * co + 6 * co * co + ci * co
    _, c_last, _, w_last = blocks[-1]
    nbytes = (rows * (conv_width(cfg) + c_last * w_last) * esize
              + weights * esize + 4 * 16 * c_last)
    return 2 * rows * macs, nbytes


def _attention_shape(cfg: Mapping):
    """(h, w, c, g) of the attention input ``[B, H=keypoints, W=time, C]``."""
    return (cfg["num_keypoints"], cfg["window_size"],
            cfg["conv_channels"][-1], cfg["attention_groups"])


def attention(cfg: Mapping, batch: int, esize: int) -> Work:
    """Both axes of the eval attention (projection, logits, p @ v)."""
    h, w, c, g = _attention_shape(cfg)
    flops = 0
    for length in (w, h):
        n = batch * h * w // length
        flops += 2 * n * length * c * 3 * c
        flops += 2 * 2 * n * g * length * length * (c // g)
    nbytes = 2 * (2 * batch * h * w * c * esize + 3 * c * c * esize
                  + 4 * (3 * c + 2 * g + 2 * c))
    return flops, nbytes


def backbone_flops(cfg: Mapping) -> float:
    """Products of one sample's TCN, conv stack and attention."""
    t = cfg["window_size"]
    return (tcn(cfg, 1, 0)[0] + conv_stack(cfg, t, 0)[0]
            + attention(cfg, 1, 0)[0])


def forward_flops(cfg: Mapping) -> float:
    """Analytic FLOPs of one sample's forward: every product and
    convolution (about 155 MFLOP for ``wiflow``), as the configuration's
    reference module counts them (its ``forward_flops``)."""
    from benchmark.reference.model import family
    return family(cfg).forward_flops(cfg)


def serve_ops(cfg: Mapping, batch: int, esize: int) -> Dict[str, Work]:
    """The three serving ops of one forward of ``batch`` samples."""
    return {"tcn": tcn(cfg, batch, esize),
            "conv_stack": conv_stack(cfg, batch * cfg["window_size"], esize),
            "attention": attention(cfg, batch, esize)}


# --- the fused train step ---------------------------------------------------

def stage_ops(cfg: Mapping, batch: int) -> List[dict]:
    """Every BN-apply -> SiLU -> dropout -> conv of a train step, from the
    architecture: per TCN level the shortcut (where the width changes),
    both grouped causal convs and both pointwise convs; per conv block
    the shortcut and the three (1, 3) convs.  ``pro``: a BN is applied
    before the conv; ``mask``: dropout before it, one bit an element or a
    (sample, channel); ``need_gx``: the input needs a gradient (all but
    the model's input)."""
    t, k = cfg["window_size"], cfg["tcn_kernel_size"]
    ops = []

    def op(kind, lead, ci, co, groups=1, pro=False, mask=None, bias=False,
           need_gx=True, taps=1):
        win = lead[-1] if len(lead) == 3 else None
        ops.append(dict(kind=kind, lead=lead, ci=ci, co=co, groups=groups,
                        pro=pro, mask=mask, bias=bias, need_gx=need_gx,
                        taps=taps, win=win))

    cin = input_channels(cfg)
    g = cfg["tcn_groups"]
    for i, cout in enumerate(cfg["tcn_channels"]):
        lead, first = (batch, t), i == 0
        if cin != cout:
            op("shortcut", lead, cin, cout, need_gx=not first)
        op("grouped", lead, cin, cin, g, need_gx=not first, taps=k)
        op("pointwise", lead, cin, cout, pro=True)
        op("grouped", lead, cout, cout, g, pro=True, mask="element", taps=k)
        op("pointwise", lead, cout, cout, pro=True)
        cin = cout
    for ci, co, w, wout in _conv_blocks(cfg):
        tag = "_strided" if wout != w else ""
        op("shortcut" + tag, (batch, t, w), ci, co)
        op("conv" + tag, (batch, t, w), ci, co, bias=True, taps=3)
        for _ in range(2):
            op("conv", (batch, t, wout), co, co, pro=True, mask="sample",
               bias=True, taps=3)
    return ops


def stage_one(c: Mapping, esize: int) -> Tuple[Work, Work]:
    """(forward, backward) work of one stage: the conv's multiply-adds
    (the backward's input and weight gradients as many again each), each
    input byte read once and each output written once."""
    if len(c["lead"]) == 3:
        win = c["lead"][-1]
        wout = (win - 1) // 2 + 1 if c["kind"].endswith("strided") else win
        rows = math.prod(c["lead"][:-1])
    else:
        win = wout = 1
        rows = math.prod(c["lead"])
    nw = c["co"] * (c["ci"] // c["groups"]) * c["taps"]
    xb, ob = rows * win * c["ci"] * esize, rows * wout * c["co"] * esize
    mask = {None: 0, "element": rows * win * c["ci"],
            "sample": c["lead"][0] * c["ci"]}[c["mask"]]
    vecs = 4 * (3 * c["ci"] * c["pro"] + c["co"] * c["bias"])
    conv = 2 * rows * wout * nw
    fwd = (conv, xb + ob + 4 * nw + mask + vecs + 8 * c["co"])
    bwd = (conv * (2 if c["need_gx"] else 1),
           xb + 2 * ob + (xb if c["need_gx"] else 0) + 8 * nw + mask
           + 2 * vecs + 8 * c["co"])
    return fwd, bwd


def join_ops(cfg: Mapping, batch: int) -> List[dict]:
    """Every residual tail of a train step (BN-apply, dropout where the
    block has it, the shortcut's BN where it has one, add, SiLU)."""
    t = cfg["window_size"]
    out, cin = [], input_channels(cfg)
    for cout in cfg["tcn_channels"]:
        out.append(dict(lead=(batch, t), c=cout, mask=True,
                        res_norm=cin != cout))
        cin = cout
    for _, co, _, wout in _conv_blocks(cfg):
        out.append(dict(lead=(batch, t, wout), c=co, mask=False,
                        res_norm=True))
    return out


def join_one(c: Mapping, esize: int) -> Tuple[Work, Work]:
    """(forward, backward) work of one residual tail: 20 / 40 FLOPs an
    element, 3 / 5 tensors of the activation's size."""
    n = math.prod(c["lead"]) * c["c"]
    mask = n if c["mask"] else 0
    vecs = 4 * 3 * c["c"] * (2 if c["res_norm"] else 1)
    return ((20 * n, 3 * n * esize + mask + vecs),
            (40 * n, 5 * n * esize + mask + 2 * vecs))


def train_attention(cfg: Mapping, batch: int, esize: int) -> Dict[str, Work]:
    """The train attention's four ops over both axes of one step: the core
    forward (logits, p @ v) and backward (logits again, dp, dq, dk, dv),
    the logits' batch sums forward (logits, sum and square) and backward
    (logits, dq, dk)."""
    h, w, c, g = _attention_shape(cfg)
    shapes = [(batch * h, w), (batch * w, h)]
    out = {}
    for kind in ("core_fwd", "core_bwd", "sums_fwd", "sums_bwd"):
        flops = nbytes = 0
        for n, length in shapes:
            pairs, rows = n * length * length, n * length * c * esize
            if kind == "core_fwd":
                flops += 4 * pairs * c
                nbytes += 4 * rows + 4 * g
            elif kind == "core_bwd":
                flops += 10 * pairs * c
                nbytes += 7 * rows + 8 * g
            elif kind == "sums_fwd":
                flops += 2 * pairs * c + 3 * pairs * g
                nbytes += 2 * rows + 8 * g
            else:
                flops += 6 * pairs * c
                nbytes += 4 * rows + 8 * g
        out[kind] = (flops, nbytes)
    return out


def train_step_bounds(cfg: Mapping, batch: int) -> Dict[str, float]:
    """Least seconds of the fused step's ``stage`` and ``join`` work and of
    the train attention's, forward and backward summed, op by op."""
    dt = cfg["compute_dtype"]
    es = ESIZE[dt]

    def total(pairs):
        return sum(bound_s(*w, dt)[0] for pair in pairs for w in pair)

    return {
        "stage": total(stage_one(c, es) for c in stage_ops(cfg, batch)),
        "join": total(join_one(c, es) for c in join_ops(cfg, batch)),
        "attention_train": sum(bound_s(*w, dt)[0] for w in
                               train_attention(cfg, batch, es).values()),
    }


def serve_bounds(cfg: Mapping, batches) -> Dict[str, float]:
    """Least seconds of each serving op over forwards of ``batches``
    samples each (one entry a call)."""
    dt = cfg["compute_dtype"]
    out: Dict[str, float] = {}
    for b in batches:
        for name, w in serve_ops(cfg, b, ESIZE[dt]).items():
            out[name] = out.get(name, 0.0) + bound_s(*w, dt)[0]
    return out
