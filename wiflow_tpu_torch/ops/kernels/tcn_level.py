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
128-wide matrix unit.  :func:`level_weights` packs a level once more for
the kernel (``kw``), by the path :func:`tcn_plan` takes for its dtype:

- bf16, the ``wgmma`` path: each grouped conv as one ``[16 ks, cgp]`` matrix
  a group (cgp the group's outputs padded to 8), its rows the taps x the
  8-channel chunks of the dense layout that the group's channels touch
  (zero on the neighbours' channels), in the tensor cores' B-fragment
  order; P1, P2 and D as ``[K, C_out]`` matrices, K padded to 16 and C_out
  to 24 NT (three warpgroups of 8 NT columns, NT a multiple of 4), in
  wgmma's B order (``fragments.py``), one 16-deep k-step after another;
- fp32, the ``fma`` path on CUDA cores: each grouped conv as one ``[3 cgp,
  cg]`` matrix a group (taps, then the group's channels padded to ``cgp``,
  a multiple of 8), P1, P2 and D as ``[K, C_out]`` matrices, K padded to
  16 and C_out to 8, as they are.

A launch on the wgmma path counts ``serve.tcn_wgmma_levels``
(``utils/trace.py``, while tracing is on) and :data:`wgmma_levels`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from wiflow_tpu_torch.ops.kernels.build import (
    SMEM_LIMIT, SMS, CudaKernel, check_tensor, dtype_code, ptr, sm_count,
    stream_ptr,
)
from wiflow_tpu_torch.ops.kernels.fragments import to_fragments, to_wgmma_b
from wiflow_tpu_torch.ops.norm import folded_bn
from wiflow_tpu_torch.utils import trace

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("tcn_level", "tcn_level_forward",
                    [_I] + [_P] * 10,
                    replaces="wiflow_tpu/ops/pallas/tcn_level.py:113")
_WARP_COLS = 8                # fp32: 16 warps, 2 along the rows, 8 along N
_MAX_NTW = 9                  # n-tiles of a warp: N <= 576
_MAX_GROUP = 32               # channels of a group (4 n-tiles)
_ZERO_BYTES = 32
_ROWS = {torch.bfloat16: 64, torch.float32: 32}   # rows of a tile
_WGS = 3                      # bf16: consumer warpgroups, each 8 NT columns
_NT_STEP = 4                  # NT a multiple of it (one kernel each)
_MAX_STAGES = 8               # bf16: slots of the weight ring
_ALIGN = 1024                 # bf16: the swizzle atoms' alignment (slack)

# Levels launched on the wgmma path (bf16), a plain integer beside
# ``KERNEL.launches``; callers may reset it to 0.
wgmma_levels = 0


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
    kw: Optional[torch.Tensor] = None   # the kernel's packing (level_weights)


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
        levels.append(level_weights(TcnLevelWeights(
            g1w, g1b, p1w, p1b, g2w, g2b, p2w, p2b, dw, db, 2 ** i)))
    return levels


def _cgp(cg: int) -> int:
    """A group's channels padded to 8: 16 bytes, one ldmatrix row."""
    return -(-cg // 8) * 8


def _odd_words(width: int) -> int:
    """A row of ``width`` elements (a multiple of 8) padded to an odd number
    of 8-element words, so that an ldmatrix's 8 rows meet no bank
    conflict."""
    return width if width // 8 % 2 else width + 8


def _window_chunks(cg: int, groups: int) -> int:
    """The 8-channel chunks of the dense layout that the widest group of
    ``cg`` channels touches: the bf16 grouped convs' window a tap."""
    return max((g * cg + cg - 1) // 8 - g * cg // 8 + 1 for g in range(groups))


class _WeightLayout(NamedTuple):
    ks: Tuple[int, int, int, int, int]     # k-steps: G1, G2, P1, P2, D
    offs: Tuple[int, int, int, int, int]   # first element of each in kw
    total: int
    ncols: int        # columns of P1, P2, D: C_out padded to 8 (fp32) or
                      # to 24 NT, NT a multiple of 4 (bf16)
    window: Tuple[int, int]   # bf16: chunks of a group's window, in / out


@functools.lru_cache(maxsize=None)
def _weight_layout(cin: int, cout: int, groups: int, has_d: bool,
                   wgmma: bool = False) -> _WeightLayout:
    cgi, cgo = cin // groups, cout // groups
    ntiles = -(-cout // 8)
    if wgmma:
        window = (_window_chunks(cgi, groups), _window_chunks(cgo, groups))
        ks_g1, ks_g2 = -(-3 * window[0] // 2), -(-3 * window[1] // 2)
        ncols = 8 * _NT_STEP * _WGS * -(-ntiles // (_NT_STEP * _WGS))
    else:
        window = (0, 0)
        ks_g1, ks_g2 = -(-3 * _cgp(cgi) // 16), -(-3 * _cgp(cgo) // 16)
        ncols = 8 * ntiles
    ks_p1, ks_p2 = -(-cin // 16), -(-cout // 16)
    ks = (ks_g1, ks_g2, ks_p1, ks_p2, ks_p1 if has_d else 0)
    sizes = (groups * ks_g1 * 16 * _cgp(cgi), groups * ks_g2 * 16 * _cgp(cgo),
             ks_p1 * 16 * ncols, ks_p2 * 16 * ncols, ks[4] * 16 * ncols)
    offs, at = [], 0
    for n in sizes:
        offs.append(at)
        at += n
    return _WeightLayout(ks, tuple(offs), at, ncols, window)


def _group_matrices(w: torch.Tensor, ks: int) -> torch.Tensor:
    """Grouped taps ``[3, G, cg, cg]`` -> ``[G, 16 ks, cgp]``: row ``j cgp +
    i`` is input channel i of tap j, zero where padded."""
    _, g, ci, co = w.shape
    cp = _cgp(ci)
    m = torch.zeros(3, g, cp, _cgp(co))
    m[:, :, :ci, :co] = w.float().cpu()
    m = m.permute(1, 0, 2, 3).reshape(g, 3 * cp, _cgp(co))
    return F.pad(m, (0, 0, 0, 16 * ks - 3 * cp))


def _window_matrices(w: torch.Tensor, ks: int, nch: int) -> torch.Tensor:
    """Grouped taps ``[3, G, cg, cg]`` -> ``[G, 16 ks, cgp]`` over the dense
    layout: row ``j 8 nch + 8 k + e`` is channel ``8 (c0 + k) + e`` of tap
    j, ``c0 = g cg // 8`` the group's first chunk, zero where that channel
    is not the group's."""
    _, g, ci, co = w.shape
    m = torch.zeros(g, 16 * ks, _cgp(co))
    for i in range(g):
        o = i * ci - (i * ci // 8) * 8
        for j in range(3):
            r = j * 8 * nch + o
            m[i, r:r + ci, :co] = w[j, i].float().cpu()
    return m


def _dense_matrix(w: torch.Tensor, ks: int, ncols: int) -> torch.Tensor:
    k, n = w.shape
    return F.pad(w.float().cpu(), (0, ncols - n, 0, 16 * ks - k))


def level_matrices(lv: TcnLevelWeights) -> List[torch.Tensor]:
    """The kernel's five weight matrices of a level in fp32, by the path of
    its dtype: G1 ``[G, 16 ks, cgp]``, G2, then P1, P2 and D ``[16 ks,
    ncols]`` (D empty for the identity residual)."""
    cin, cout = lv.p1w.shape
    wgmma = lv.p1w.dtype == torch.bfloat16
    lay = _weight_layout(cin, cout, lv.g1w.shape[1], lv.dw is not None,
                         wgmma)
    if wgmma:
        mats = [_window_matrices(lv.g1w, lay.ks[0], lay.window[0]),
                _window_matrices(lv.g2w, lay.ks[1], lay.window[1])]
    else:
        mats = [_group_matrices(lv.g1w, lay.ks[0]),
                _group_matrices(lv.g2w, lay.ks[1])]
    mats += [_dense_matrix(lv.p1w, lay.ks[2], lay.ncols),
             _dense_matrix(lv.p2w, lay.ks[3], lay.ncols)]
    mats.append(_dense_matrix(lv.dw, lay.ks[4], lay.ncols)
                if lv.dw is not None else torch.zeros(0, lay.ncols))
    return mats


def level_weights(lv: TcnLevelWeights) -> TcnLevelWeights:
    """``lv`` with ``kw``, the kernel's packing of its weights (see the
    module note), in the weights' dtype and on their device."""
    dt, dev = lv.p1w.dtype, lv.p1w.device
    parts = []
    for m in level_matrices(lv):
        if dt == torch.bfloat16 and m.numel():
            m = (torch.cat([to_fragments(g) for g in m]) if m.ndim == 3
                 else to_wgmma_b(m))
        parts.append(m.reshape(-1))
    return lv._replace(kw=torch.cat(parts).to(device=dev, dtype=dt))


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


class TcnPlan(NamedTuple):
    """One launch of the kernel: what ``csrc/tcn_level.cu`` is given."""

    samples: int            # samples a tile of rows
    rows: int               # rows of a tile, padded: 64 bf16, 32 fp32
    grid: int               # blocks: one an SM, at most one a tile
    blocks_per_sm: int
    smem: int               # bytes of shared memory a block
    stages: int             # slots of the weight ring (bf16), 0 in fp32
    ntw: int                # n-tiles of a warpgroup's wgmma (bf16), of a
                            # warp's products (fp32)
    dims: Tuple[int, ...]   # the C side's ints: 24 bf16, 28 fp32
    path: str               # "wgmma" (bf16) or "fma" (fp32, CUDA cores)


@functools.lru_cache(maxsize=None)
def tcn_plan(batch: int, steps: int, cin: int, cout: int, groups: int,
             dil: int, has_d: bool, dtype: torch.dtype,
             sms: int = SMS) -> TcnPlan:
    """The launch of one level on ``[batch, steps, cin]``.  Pure: the CPU
    tests hold it.

    bf16, the ``wgmma`` path: two buffers of 64 rows, channel-last in
    128-byte swizzled atoms of 64 channels (x, then h2, then x again; h1,
    then h3), a ring of 2-8 weight k-steps (as many as fit), the biases,
    a row of zeros, two 8-byte mbarriers a slot, and 1024 bytes of slack
    to align the atoms.  C_out is split over three warpgroups of 8 NT
    columns each, NT a multiple of 4 (one instantiation of the kernel
    each).

    fp32, the ``fma`` path: two buffers of 32 rows: buf0 holds x
    group-padded, then h2 group-padded, then x dense; buf1 h1, then h3,
    dense.  Then a row of zeros and each channel's group-padded column (2
    bytes a channel, in and out)."""
    if dtype not in _ROWS:
        raise TypeError(f"tcn_level takes float32 or bfloat16, got {dtype}")
    if cin % groups or cout % groups:
        raise ValueError(f"{groups} groups do not divide {cin} -> {cout}")
    if max(cin, cout) // groups > _MAX_GROUP:
        raise ValueError(f"the kernel's grouped convs take at most "
                         f"{_MAX_GROUP} channels a group")
    ntiles = -(-cout // 8)
    if ntiles > _WARP_COLS * _MAX_NTW:
        raise ValueError(f"C_out = {cout}: the kernel takes at most "
                         f"{8 * _WARP_COLS * _MAX_NTW} output channels")
    rows = _ROWS[dtype]
    samples = rows // steps
    if samples < 1:
        raise ValueError(f"{steps} time steps do not fit a tile of {rows} "
                         f"rows")
    wgmma = dtype == torch.bfloat16
    lay = _weight_layout(cin, cout, groups, has_d, wgmma)
    grid = min(-(-batch // samples), sms)

    def al(v):
        return -(-v // 16) * 16

    if wgmma:
        nt = lay.ncols // (8 * _WGS)
        kbuf = -(-max(cin, cout) // 64) * 64
        al4 = lambda v: -(-v // 4) * 4   # noqa: E731
        fixed = 2 * kbuf * 128 + al(4 * (al4(cin) + al4(cout) + (
            3 if has_d else 2) * lay.ncols)) + 16 + _ALIGN
        slot = 32 * lay.ncols + 16      # a k-step and its two mbarriers
        stages = min(_MAX_STAGES, (SMEM_LIMIT - fixed) // slot)
        smem = fixed + max(stages, 2) * slot
        dims = (batch, steps, cin, cout, groups, dil, samples, *lay.window,
                kbuf, nt, stages, *lay.ks, grid, smem, *lay.offs)
    else:
        cgp_in, cgp_out = _cgp(cin // groups), _cgp(cout // groups)
        ldg_in = _odd_words(groups * cgp_in)
        ldg_out = _odd_words(groups * cgp_out)
        ldd_in = _odd_words(-(-cin // 16) * 16)
        ldd_out = _odd_words(-(-cout // 16) * 16)
        buf0, buf1 = max(ldg_in, ldg_out, ldd_in), max(ldd_in, ldd_out)
        nt, stages = -(-ntiles // _WARP_COLS), 0
        smem = al(rows * buf0 * 4) + al(rows * buf1 * 4) + _ZERO_BYTES \
            + al(2 * (cin + cout))
        dims = (batch, steps, cin, cout, groups, dil, samples, cgp_in,
                cgp_out, ldg_in, ldd_in, ldg_out, ldd_out, buf0, buf1, ntiles,
                *lay.ks, grid, smem, *lay.offs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a tile of {rows} rows needs {smem} bytes of shared "
                         f"memory, more than the {SMEM_LIMIT} of a block")
    return TcnPlan(samples, rows, grid, 1, smem, stages, nt, dims,
                   "wgmma" if wgmma else "fma")


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
    if (lv.dw is None) != (cin == cout):
        raise ValueError("the residual 1x1 is needed exactly when C_in != "
                         "C_out")
    if lv.dw is not None:
        check_tensor(lv.dw, "dw", device=dev, dtype=dt, shape=(cin, cout))
        check_tensor(lv.db, "db", device=dev, dtype=torch.float32,
                     shape=(cout,))
    plan = tcn_plan(b, t, cin, cout, groups, lv.dilation, lv.dw is not None,
                    dt, sm_count(dev.index or 0))
    if lv.kw is None:
        raise ValueError("the level is not packed for the kernel: pass it "
                         "through level_weights (pack_tcn_levels does)")
    check_tensor(lv.kw, "kw", device=dev, dtype=dt,
                 shape=(_weight_layout(cin, cout, groups, lv.dw is not None,
                                       plan.path == "wgmma").total,))
    out = torch.empty((b, t, cout), dtype=dt, device=dev)
    dims = (ctypes.c_int * len(plan.dims))(*plan.dims)
    KERNEL.launch(dtype_code(dt), ptr(x), ptr(out), ptr(lv.kw), ptr(lv.g1b),
                  ptr(lv.p1b), ptr(lv.g2b), ptr(lv.p2b), ptr(lv.db), dims,
                  stream_ptr(dev))
    if plan.path == "wgmma":
        global wgmma_levels
        wgmma_levels += 1
        trace.count("serve.tcn_wgmma_levels")
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
