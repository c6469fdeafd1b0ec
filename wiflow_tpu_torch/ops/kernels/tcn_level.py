"""Fused eval TCN level: CUDA kernel, its plain version, and the packer.

Counterpart of ``wiflow_tpu/ops/pallas/tcn_level.py`` (``fused_tcn_eval``,
``pack_tcn_levels``).  One call of :func:`tcn_level` runs one level of the
BN-folded TCN on ``[B, T, C_in]`` -> ``[B, T, C_out]``:

    h1  = silu(causal grouped conv(x)  + b1)     -> rounded to x.dtype
    h2  = silu(h1 @ P1 + c1)                     -> rounded
    h3  = silu(causal grouped conv(h2) + b2)     -> rounded
    y   = silu(h3 @ P2 + c2)
    out = silu(y + (x @ D + e if C_in != C_out else x))

On a CUDA tensor it launches ``csrc/tcn_level.cu`` (one launch per level);
on a CPU tensor it runs :func:`tcn_level_plain`, the same arithmetic in
stock torch ops.  Unlike the TPU packer, the grouped taps stay grouped
(``[3, G, ci, co]``): the block-diagonal form only filled the TPU's
128-wide matrix unit.
"""

from __future__ import annotations

import ctypes
from typing import List, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from wiflow_tpu_torch.ops.kernels.build import (
    SMEM_LIMIT, CudaKernel, check_tensor, dtype_code, ptr, stream_ptr,
)
from wiflow_tpu_torch.ops.norm import folded_bn

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("tcn_level", "tcn_level_forward",
                    [_I, _P, _P] + [_I] * 9 + [_P] * 10 + [_P],
                    replaces="wiflow_tpu/ops/pallas/tcn_level.py:113")
# the kernel's weight tile in shared memory: 32 x 64 fp32 (CUDA-core
# product) or the transposed 64 x (128 + 8) bf16 tile (tensor cores)
_TILE_BYTES = {torch.float32: 32 * 64 * 4, torch.bfloat16: 64 * 136 * 2}
_MAX_SAMPLES = 4
_MAX_BUF_ROWS = 80


class TcnLevelWeights(NamedTuple):
    """One level, BN folded.  Weights in the compute dtype, biases fp32."""

    g1w: torch.Tensor                 # [3, G, C_in/G, C_in/G]
    g1b: torch.Tensor                 # [C_in]
    p1w: torch.Tensor                 # [C_in, C_out]
    p1b: torch.Tensor                 # [C_out]
    g2w: torch.Tensor                 # [3, G, C_out/G, C_out/G]
    g2b: torch.Tensor                 # [C_out]
    p2w: torch.Tensor                 # [C_out, C_out]
    p2b: torch.Tensor                 # [C_out]
    dw: Optional[torch.Tensor]        # [C_in, C_out] when C_in != C_out
    db: Optional[torch.Tensor]        # [C_out]
    dilation: int


def pack_tcn_levels(state_dict: Mapping[str, torch.Tensor], n_levels: int,
                    groups: int, *, dtype: torch.dtype,
                    device: torch.device) -> List[TcnLevelWeights]:
    """Fold each level's eval BNs into its conv weights, once.

    ``state_dict`` holds torch-layout weights under ``tcn.network.{i}``
    (the reference names, ``models/torch_compat.py``).
    """
    def cast(w):
        return w.to(device=device, dtype=dtype).contiguous()

    def bias(b):
        return b.to(device=device, dtype=torch.float32).contiguous()

    levels = []
    for i in range(n_levels):
        p = f"tcn.network.{i}"

        def grouped(name, bn):
            sc, bi = folded_bn(state_dict, f"{p}.{bn}")
            w = state_dict[f"{p}.{name}.weight"].float() * sc[:, None, None]
            c, ci, k = w.shape                        # [C_out, C_in/G, K]
            w = w.reshape(groups, c // groups, ci, k).permute(3, 0, 2, 1)
            return cast(w), bias(bi)

        def pointwise(name, bn):
            sc, bi = folded_bn(state_dict, f"{p}.{bn}")
            w = state_dict[f"{p}.{name}.weight"].float()[:, :, 0]
            return cast((w * sc[:, None]).t()), bias(bi)

        g1w, g1b = grouped("conv1_group", "bn1_group")
        p1w, p1b = pointwise("conv1_pw", "bn1_pw")
        g2w, g2b = grouped("conv2_group", "bn2_group")
        p2w, p2b = pointwise("conv2_pw", "bn2_pw")
        dw = db = None
        if f"{p}.downsample.0.weight" in state_dict:
            dw, db = pointwise("downsample.0", "downsample.1")
        levels.append(TcnLevelWeights(g1w, g1b, p1w, p1b, g2w, g2b, p2w, p2b,
                                      dw, db, 2 ** i))
    return levels


def _grouped_causal_plain(x: torch.Tensor, w: torch.Tensor,
                          dil: int) -> torch.Tensor:
    """fp32 causal grouped conv: ``x [B, T, C]``, ``w [K, G, ci, co]``."""
    b, t, c = x.shape
    k, g, ci, co = w.shape
    xg = x.float().reshape(b, t, g, ci)
    acc = None
    for j in range(k):
        shift = (k - 1 - j) * dil
        seg = F.pad(xg, (0, 0, 0, 0, shift, 0))[:, :t]
        y = torch.einsum("btgi,gio->btgo", seg, w[j].float())
        acc = y if acc is None else acc + y
    return acc.reshape(b, t, g * co)


def tcn_level_plain(x: torch.Tensor, lv: TcnLevelWeights) -> torch.Tensor:
    """Stock-torch version of the kernel: same arithmetic, same roundings."""
    dt, silu = x.dtype, F.silu
    h = silu(_grouped_causal_plain(x, lv.g1w, lv.dilation) + lv.g1b).to(dt)
    h = silu(h.float() @ lv.p1w.float() + lv.p1b).to(dt)
    h = silu(_grouped_causal_plain(h, lv.g2w, lv.dilation) + lv.g2b).to(dt)
    y = silu(h.float() @ lv.p2w.float() + lv.p2b)
    res = x.float() if lv.dw is None else x.float() @ lv.dw.float() + lv.db
    return silu(y + res).to(dt)


def _buf_rows(samples: int, t: int) -> int:
    """Rows of a block's activation buffer: its samples' rows, padded to
    the tensor cores' 16-row tiles."""
    return -(-samples * t // 16) * 16


def _launch(x: torch.Tensor, lv: TcnLevelWeights) -> torch.Tensor:
    b, t, cin = x.shape
    cout = lv.p1w.shape[1]
    groups = lv.g1w.shape[1]
    dev, dt = x.device, x.dtype
    check_tensor(x, "x", device=dev, dtype=dt)
    for name, shape in (("g1w", (3, groups, cin // groups, cin // groups)),
                        ("p1w", (cin, cout)),
                        ("g2w", (3, groups, cout // groups, cout // groups)),
                        ("p2w", (cout, cout))):
        check_tensor(getattr(lv, name), name, device=dev, dtype=dt,
                     shape=shape)
    for name, n in (("g1b", cin), ("p1b", cout), ("g2b", cout),
                    ("p2b", cout)):
        check_tensor(getattr(lv, name), name, device=dev,
                     dtype=torch.float32, shape=(n,))
    if cin % groups or cout % groups:
        raise ValueError(f"{groups} groups do not divide {cin} -> {cout}")
    if dt == torch.bfloat16 and max(cin, cout) // groups > 32:
        raise ValueError("the bf16 kernel's grouped convs take at most 32 "
                         "channels per group")
    if (lv.dw is None) != (cin == cout):
        raise ValueError("the residual 1x1 is needed exactly when C_in != "
                         "C_out")
    if lv.dw is not None:
        check_tensor(lv.dw, "dw", device=dev, dtype=dt, shape=(cin, cout))
        check_tensor(lv.db, "db", device=dev, dtype=torch.float32,
                     shape=(cout,))
    # row stride: a multiple of 16 plus 8 keeps the tensor-core operand
    # loads free of shared-memory bank conflicts
    lda = -(-max(cin, cout) // 16) * 16 + 8
    esize = x.element_size()

    def smem(samples):
        return 2 * _buf_rows(samples, t) * lda * esize + _TILE_BYTES[dt]

    samples = _MAX_SAMPLES
    while samples and (_buf_rows(samples, t) > _MAX_BUF_ROWS
                       or smem(samples) > SMEM_LIMIT):
        samples -= 1
    if samples < 1:
        raise ValueError(f"a [{t}, {max(cin, cout)}] sample does not fit one "
                         f"thread block")
    out = torch.empty((b, t, cout), dtype=dt, device=dev)
    KERNEL.launch(dtype_code(dt), ptr(x), ptr(out), b * t, t, samples,
                  _buf_rows(samples, t), lda, cin, cout, groups, lv.dilation,
                  ptr(lv.g1w), ptr(lv.g1b), ptr(lv.p1w), ptr(lv.p1b),
                  ptr(lv.g2w), ptr(lv.g2b), ptr(lv.p2w), ptr(lv.p2b),
                  ptr(lv.dw), ptr(lv.db), stream_ptr(dev))
    return out


def tcn_level(x: torch.Tensor, lv: TcnLevelWeights) -> torch.Tensor:
    """One folded TCN level, ``[B, T, C_in]`` -> ``[B, T, C_out]``.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`tcn_level_plain`.
    """
    if x.device.type == "cuda":
        return _launch(x, lv)
    if x.device.type == "cpu":
        return tcn_level_plain(x, lv)
    raise ValueError(f"tcn_level runs on cuda or cpu tensors, not {x.device}")


def fused_tcn_eval(x: torch.Tensor,
                   levels: List[TcnLevelWeights]) -> torch.Tensor:
    """The folded TCN stack on ``[B, T, C0]`` -> ``[B, T, C_last]``."""
    for lv in levels:
        x = tcn_level(x, lv)
    return x
