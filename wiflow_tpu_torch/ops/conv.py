"""Plain-torch references for the convolutions of the serving path.

Counterpart of ``wiflow_tpu/ops/conv.py``.  Activations stay channel-last,
as in the JAX package (``[B, T, C]`` in 1-D, ``[B, H, W, C]`` in 2-D with
H = time and W = subcarrier); weights are in torch's own layouts, the
layouts of the reference ``state_dict`` the port's modules hold:

  grouped / pointwise Conv1d  ``[Co, Ci/G, K]``
  (1, K) and 1x1 Conv2d       ``[Co, Ci, 1, K]``
  3x3 Conv2d                  ``[Co, Ci, 3, 3]``

The JAX file's custom VJPs work around XLA's transposes; autograd needs
none of them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _cf(x: torch.Tensor) -> torch.Tensor:
    """Channel-last -> channel-first."""
    return x.movedim(-1, 1)


def _cl(x: torch.Tensor) -> torch.Tensor:
    """Channel-first -> channel-last."""
    return x.movedim(1, -1)


def causal_grouped_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                          dilation: int, groups: int) -> torch.Tensor:
    """Causal dilated grouped Conv1d on ``x [B, T, C]``.

    torch ``Conv1d(padding=(K-1)*d, dilation=d, groups=G, bias=False)``
    followed by ``Chomp1d((K-1)*d)`` (ref models/tcn.py:6-12,20-23) is a
    left pad of ``(K-1)*d`` and no right pad.
    """
    k = w.shape[-1]
    xp = F.pad(_cf(x), ((k - 1) * dilation, 0))
    return _cl(F.conv1d(xp, w.to(x.dtype), dilation=dilation, groups=groups))


def pointwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 Conv1d without bias on ``x [B, T, Ci]``; ``w [Co, Ci, 1]``."""
    return _cl(F.conv1d(_cf(x), w.to(x.dtype)))


def conv1xk_w(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              stride: int = 1) -> torch.Tensor:
    """(1, K) Conv2d over W on ``x [B, H, W, Ci]``; ``w [Co, Ci, 1, K]``.

    torch ``Conv2d(kernel_size=(1, K), stride=(1, s), padding=(0, K // 2))``
    (ref models/convnet.py:11-23); widths go 240 -> 120 -> 60 -> 30 -> 15.
    """
    return _cl(F.conv2d(_cf(x), w.to(x.dtype), b.to(x.dtype),
                        stride=(1, stride), padding=(0, w.shape[-1] // 2)))


def conv1x1_2d(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *,
               stride_w: int = 1) -> torch.Tensor:
    """1x1 Conv2d, optionally strided along W; ``w [Co, Ci, 1, 1]``."""
    bias = None if b is None else b.to(x.dtype)
    return _cl(F.conv2d(_cf(x), w.to(x.dtype), bias, stride=(1, stride_w)))


def conv3x3_2d(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME Conv2d (decoder head, ref models/pose_model.py:45)."""
    return _cl(F.conv2d(_cf(x), w.to(x.dtype), b.to(x.dtype), padding=1))
