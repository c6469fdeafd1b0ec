"""The orders in which the tensor cores read a B operand.

Kernels that keep a bf16 weight matrix ``[K, N]`` for the tensor cores
store it packed.  For ``mma.sync.m16n8k16`` (:func:`to_fragments`) each
lane loads the two registers of its B fragment with one 8-byte load:
``[K / 16][N / 8][lane][4]``, lane ``4 gid + tig`` holding rows ``2 tig``,
``2 tig + 1``, ``2 tig + 8``, ``2 tig + 9`` of its 16-deep step at column
``gid`` of its 8-column tile (``csrc/mma.cuh``).  For ``wgmma``
(:func:`to_wgmma_b`) a 16-deep k-step is copied whole into shared memory and
read there K-major without swizzle (``csrc/wgmma.cuh``).
"""

from __future__ import annotations

import torch


def to_fragments(m: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` (K a multiple of 16, N of 8) -> the flat fragment order."""
    kp, n = m.shape
    return m.reshape(kp // 16, 2, 4, 2, n // 8, 8).permute(
        0, 4, 5, 2, 1, 3).reshape(-1)


def to_wgmma_b(m: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` (K a multiple of 16, N of 8) -> wgmma's no-swizzle K-major
    B order, one 16-deep k-step after another: ``[K / 16][N / 8][2][8][8]``
    (k-step, 8-column block, k half, column, k), each 8 x 8 core matrix 128
    contiguous bytes, its rows the columns of ``m``."""
    kp, n = m.shape
    return m.reshape(kp // 16, 2, 8, n // 8, 8).permute(
        0, 3, 1, 4, 2).reshape(-1)
