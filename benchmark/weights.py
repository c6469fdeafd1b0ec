"""Weights of a configuration, drawn from a seed on the device.

A few large draws from one ``torch.Generator`` on the device (one normal
draw for the Conv1d weights, one uniform draw for everything else), cut
into the leaves of :func:`benchmark.reference.model.spec`:

* Conv1d: kaiming-normal fan-out, ``N(0, 2 / (C_out x K))``;
* Conv2d weight and bias: uniform in ``+-1 / sqrt(fan_in)``;
* BatchNorm: scale in [0.3, 0.8), shift in [-0.1, 0.1); the running
  mean and variance are those of a batch of ``CALIBRATION`` samples
  drawn as the traffic draws them (standard normal), taken by the
  reference's train-mode forward without dropout, as a trained model's
  would be.  So folding them into the convolutions does real work and the
  served output varies from window to window as much as it varies over
  the data, not by a thousandth of its size.

The same seed gives the same weights on the same kind of device.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from benchmark.reference.model import Run, forward, input_shape, spec, state

# kind -> (low, high) of a uniform draw; the running statistics start at
# torch's 0 and 1 and are then set from the calibration batch
_UNIFORM = {"bn_weight": (0.3, 0.8), "bn_bias": (-0.1, 0.1),
            "running_mean": (0.0, 0.0), "running_var": (1.0, 1.0)}
CALIBRATION = 512


def draw(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``cfg`` under the published names, float32
    on ``device`` (``num_batches_tracked`` as int64 zeros)."""
    leaves = spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_normal = sum(math.prod(s) for _, s, k in leaves if k == "conv1d")
    n_uniform = sum(math.prod(s) for _, s, k in leaves
                    if k not in ("conv1d", "count"))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i, j = {}, 0, 0
    fan_in = {}
    for name, shape, kind in leaves:
        n = math.prod(shape)
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        if kind == "conv1d":
            std = math.sqrt(2.0 / (shape[0] * shape[-1]))
            out[name] = (normal[i:i + n] * std).reshape(shape)
            i += n
            continue
        u = uniform[j:j + n].reshape(shape)
        j += n
        if kind == "conv2d":
            fan_in[name.rsplit(".", 1)[0]] = math.prod(shape[1:])
            b = 1.0 / math.sqrt(math.prod(shape[1:]))
            out[name] = (2 * u - 1) * b
        elif kind == "conv2d_bias":
            b = 1.0 / math.sqrt(fan_in[name.rsplit(".", 1)[0]])
            out[name] = (2 * u - 1) * b
        else:
            lo, hi = _UNIFORM[kind]
            out[name] = lo + (hi - lo) * u
    x = torch.randn((CALIBRATION, *input_shape(cfg)), generator=gen,
                    device=device)
    stats: Dict[str, tuple] = {}
    with torch.no_grad():
        forward(Run(state(out, device), train=True, stats=stats), x, cfg)
    for prefix, (mean, var, _) in stats.items():
        out[f"{prefix}.running_mean"] = mean
        out[f"{prefix}.running_var"] = var
    return out
