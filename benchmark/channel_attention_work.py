"""Operations and bytes of WPformer's channel attention core, from a
configuration's shapes: the yardstick of ``roofline.channel_attention``.

The core of one window (``benchmark/reference/wpformer.py``'s
``channel_attention`` between the projections and ``out1``): per head
the scores ``Q^T K`` ``[C, C]`` over N tokens and the context ``P V^T``,
``4 H C^2 N`` FLOPs; bytes: Q, K, V read once and the heads' mean
context written once, ``(3 H + 1) N C`` elements of the compute dtype.
The normalisation and softmax are ``O(H C^2)``, below both.  At N =
2,160, C = 256, H = 3: 1.70 GFLOP and 11.06 MB a window, so bytes bound
it (3.3 us at 3.35 TB/s).  Conventions and peaks as ``benchmark/work.py``.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

from benchmark import work


def tokens_channels_heads(cfg: Mapping) -> Tuple[int, int, int]:
    """(N, C, H) of the transformer: the trunk's output grid (each layer
    after the first halves it, 3x3 at stride 2, padding 1) with the
    streams side by side along its width, the trunk's last width, the
    heads."""
    h, w = cfg["resize_to"]
    for _ in cfg["trunk_widths"][1:]:
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return h * w * cfg["num_chunks"], cfg["trunk_widths"][-1], cfg["heads"]


def core(cfg: Mapping, batch: int) -> work.Work:
    """(FLOPs, bytes) of the core over ``batch`` windows, every layer."""
    n, c, heads = tokens_channels_heads(cfg)
    esize = work.ESIZE[cfg["compute_dtype"]]
    layers = cfg["num_layers"]
    return (layers * batch * 4.0 * heads * c * c * n,
            layers * batch * (3 * heads + 1) * n * c * esize)


def bound_s(cfg: Mapping, batches: Sequence[int]) -> float:
    """Least seconds of the core over forwards of ``batches`` windows each
    (one entry a call)."""
    return sum(work.bound_s(*core(cfg, b), cfg["compute_dtype"])[0]
               for b in batches)
