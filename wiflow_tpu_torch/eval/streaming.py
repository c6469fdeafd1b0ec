"""Continuous-stream pose inference over a long CSI recording.

Counterpart of ``wiflow_tpu/eval/streaming.py``: a ``[T, 540]`` stream
yields ``[T - 19, 15, 2]`` poses by sliding the 20-frame window.  The
windows are a strided view of the stream on the device, processed in
fixed-size batches; the tail is padded to the batch size and sliced off,
so every call of ``apply_fn`` sees the same shape.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from wiflow_tpu_torch.core.config import resolve_device


def sliding_windows(stream: torch.Tensor, window: int,
                    stride: int = 1) -> torch.Tensor:
    """``[T, S]`` -> ``[N, S, window]`` windows (a view, no copy)."""
    return stream.unfold(0, window, stride)


def make_stream_infer(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                      window: int = 20, stride: int = 1, batch: int = 1024,
                      device=None):
    """Build ``infer(stream [T, S]) -> poses [N, K, D]``.

    ``apply_fn`` maps a ``[batch, S, window]`` tensor to keypoints, e.g.
    ``lambda b: fast_forward(packed, b)``.  The stream is moved to
    ``device`` (CUDA unless ``"cpu"`` is asked for) as float32.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def infer(stream) -> torch.Tensor:
        if not torch.is_tensor(stream):
            stream = torch.from_numpy(np.asarray(stream, np.float32))
        stream = stream.to(device=dev, dtype=torch.float32)
        win = sliding_windows(stream, window, stride)
        n = win.shape[0]
        win = F.pad(win, (0, 0, 0, 0, 0, (-n) % batch))
        poses = [apply_fn(win[i:i + batch])
                 for i in range(0, win.shape[0], batch)]
        return torch.cat(poses)[:n]

    return infer
