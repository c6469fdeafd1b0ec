"""Train-mode attention core and logits sums: CUDA kernels, plain versions.

Counterpart of ``wiflow_tpu/ops/pallas/axial_attention_train.py``.  On
``q, k, v [N, L, C]`` (N sequences of L positions, channels in the
standard group-major order, ``channel = g * gc + cc``):

    axial_core(q, k, v, scale)  = softmax_j(scale_g * q_i . k_j) @ v
    logits_sums(q, k, groups)   = [sum, sum of squares] of the raw logits
                                  q_i . k_j over (n, i, j), per group: [2, G]

Both are ``torch.autograd.Function``s whose forward and backward are
kernels (``csrc/axial_core.cu``, ``csrc/logits_sums.cu``, 8 channels per
group); the backwards recompute what they need rather than save it.
:func:`train_attention_plan` sizes the ``axial_core`` launches: tiles of
whole sequences, threads, shared memory and a persistent grid;
:func:`sums_plan` the ``logits_sums`` launches, which work in the Gram form
(linear in L): lanes a (sequence, group), tiles, a persistent grid.  The
BatchNorm on the logits reduces to the per-group scale
``gamma * rsqrt(var + eps)`` (``models/wiflow.py::AxialAttention``), and
``logits_moments_fused`` gives the batch (mean, var) it needs from the
sums.  q, k and v may be the thirds of one ``[N, L, 3C]`` projection: the
kernels read them in place through their position stride.

A CUDA tensor goes through the kernels (or raises); a CPU tensor through
the plain versions, stock torch ops that autograd differentiates.  The
TPU kernels' scrambled ``[L, C, N]`` layout and lane padding are not
carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from wiflow_tpu_torch.ops.kernels.build import (
    SMEM_LIMIT, SMS, CudaKernel, check_tensor, dtype_code, ptr, sm_count,
    stream_ptr,
)
from wiflow_tpu_torch.parallel.mesh import global_sums

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_TPU = "wiflow_tpu/ops/pallas/axial_attention_train.py"
CORE_FORWARD = CudaKernel(
    "axial_core", "axial_core_forward",
    [_I, _P, _P, _P, _I, _P] + [_I] * 7 + [_P, _S, _P],
    replaces=f"{_TPU}:217")
CORE_BACKWARD = CudaKernel(
    "axial_core", "axial_core_backward",
    [_I, _P, _P, _P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P, _P, _P, _S, _P],
    replaces=f"{_TPU}:244")
SUMS_FORWARD = CudaKernel(
    "logits_sums", "logits_sums_forward",
    [_I, _P, _P] + [_I] * 9 + [_P, _P, _P, _P],
    replaces=f"{_TPU}:354")
SUMS_BACKWARD = CudaKernel(
    "logits_sums", "logits_sums_backward",
    [_I, _P, _P, _I, _P, _P, _P] + [_I] * 8 + [_P],
    replaces=f"{_TPU}:373")
KERNELS = (CORE_FORWARD, CORE_BACKWARD, SUMS_FORWARD, SUMS_BACKWARD)

_GROUP_CHANNELS = 8
_MAX_LEN = 32
# axial_core's tiles: positions a tile, at most, forward and backward (the
# fastest of 80, 60, 48, 40 and 30 on an H100 at both models' train shapes:
# ``train_attention_sweep.py``)
_FORWARD_POSITIONS = 40
_BACKWARD_POSITIONS = 60
_QUERIES = 2                  # queries (backward pass 2: keys) a thread
# a block's most threads (csrc/axial_attention_eval.cuh: kMaxAttnThreads),
# and the registers a thread may use under __launch_bounds__(320, 2): 32
# threads x 96 registers a warp, allocated in whole units of 256
_MAX_THREADS = 320
_MAX_REGISTERS = 65536 // (2 * _MAX_THREADS) // 8 * 8
_SM_SMEM = 233472             # shared memory of an SM (228 KB)
_BLOCK_RESERVED = 1024        # of it held back for each resident block
# logits_sums (csrc/logits_sums.cu): a block's threads; the blocks an SM
# at the forward's and the backward's launch bounds (kForwardBlocksPerSm,
# kBackwardBlocksPerSm); the numbers of ranges of positions a lane may
# take, fewest first (``logits_sums_sweep.py`` times each)
_SUMS_THREADS = 256
_SUMS_BLOCKS_PER_SM = (3, 2)
_SUMS_PARTS = (1, 2, 4)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc(t: torch.Tensor) -> torch.Tensor:
    """The accumulation type: fp32, or float64 for float64 inputs."""
    return t if t.dtype == torch.float64 else t.float()


def axial_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``softmax_j(scale_g * q_i . k_j) @ v`` in stock torch ops; the
    output has q's dtype."""
    n, length, c = q.shape
    g = scale.shape[0]
    qf, kf, vf = (_acc(t).reshape(n, length, g, c // g) for t in (q, k, v))
    lg = torch.einsum("nigc,njgc->ngij", qf, kf)
    p = torch.softmax(lg * _acc(scale)[None, :, None, None], dim=-1)
    out = torch.einsum("ngij,njgc->nigc", p, vf)
    return out.reshape(n, length, c).to(q.dtype)


def logits_sums_plain(q: torch.Tensor, k: torch.Tensor,
                      groups: int) -> torch.Tensor:
    """``[2, G]`` sums of the logits and their squares through the Gram
    identity ``sum_ij (q_i . k_j)^2 = <Q^T Q, K^T K>``, no logits."""
    n, length, c = q.shape
    gc = c // groups
    qf = _acc(q).reshape(n, length, groups, gc)
    kf = _acc(k).reshape(n, length, groups, gc)
    s1 = torch.einsum("ngc,ngc->g", qf.sum(1), kf.sum(1))
    gq = torch.einsum("nigc,nigd->ngcd", qf, qf)
    gk = torch.einsum("nigc,nigd->ngcd", kf, kf)
    s2 = torch.einsum("ngcd,ngcd->g", gq, gk)
    return torch.stack([s1, s2])


def _moments(sums: torch.Tensor, count: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = sums[0] / count
    return mean, sums[1] / count - mean * mean


def logits_moments(q: torch.Tensor, k: torch.Tensor, groups: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-group (mean, biased var) of the logits, plain version."""
    n, length, _ = q.shape
    return _moments(logits_sums_plain(q, k, groups), n * length * length)


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _staged_row(c: int, backward: bool) -> int:
    """Floats of a staged position: q, k, v (and dout) in sections of C + 8
    (``csrc/axial_attention_eval.cuh``: ``qkv_ld``; ``axial_core.cu``:
    ``bwd_ld``)."""
    return 4 * c + 32 if backward else 3 * c + 24


class CorePlan(NamedTuple):
    """One launch of ``csrc/axial_core.cu``."""

    seqs: int            # whole sequences a tile
    threads: int         # a block's threads
    smem: int            # bytes of shared memory a block
    layout: Tuple[int, ...]   # bytes: the staged fp32 rows; backward also
    #                      the next tile's rows as they come, the row
    #                      statistics, the dscale terms, the dscale sums
    blocks_per_sm: int
    tiles: int
    grid: int            # persistent: at most blocks_per_sm x SMs


class TrainAttentionPlan(NamedTuple):
    forward: CorePlan
    backward: CorePlan


def _core_threads(items: int) -> int:
    """Whole warps, at most ``_MAX_THREADS``, that take a tile's ``items``
    in whole turns of equal size."""
    turns = -(-items // _MAX_THREADS)
    return -(-items // (turns * 32)) * 32


def _blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks that fit an SM's shared memory and its 65,536 registers at
    ``_MAX_REGISTERS`` a thread."""
    warps = threads // 32
    return min(_SM_SMEM // (smem + _BLOCK_RESERVED),
               65536 // (_MAX_REGISTERS * 32 * warps))


def _core_plan(nseq: int, length: int, c: int, groups: int, esize: int,
               positions: int, backward: bool, sms: int) -> CorePlan:
    seqs = max(1, positions // length)
    npos = seqs * length
    layout = (npos * _staged_row(c, backward) * 4,)
    if backward:
        pairs = -(-length // _QUERIES)
        layout += (npos * 4 * c * esize, _align16(npos * groups * 8),
                   _align16(seqs * pairs * groups * 4), _align16(groups * 4))
    smem = sum(layout)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a tile of {npos} positions needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    threads = _core_threads(seqs * -(-length // _QUERIES) * groups)
    bps = _blocks_per_sm(smem, threads)
    tiles = -(-nseq // seqs)
    return CorePlan(seqs, threads, smem, layout, bps, tiles,
                    max(1, min(tiles, bps * sms)))


@functools.lru_cache(maxsize=None)
def train_attention_plan(nseq: int, length: int, c: int, groups: int,
                         dtype: torch.dtype, sms: int = SMS
                         ) -> TrainAttentionPlan:
    """The forward and backward launches of ``axial_core`` on ``nseq``
    sequences of ``length`` positions, ``c = 8 groups`` channels.  Pure: the
    CPU tests hold it.

    A tile is whole sequences, at most ``_FORWARD_POSITIONS`` /
    ``_BACKWARD_POSITIONS`` positions.  A block's threads take the tile's
    (sequence, query pair, group) items in whole turns; its shared memory
    holds the tile's rows staged in fp32 and, backward, the next tile's
    rows in ``dtype`` as they arrive, the rows' statistics and the dscale
    terms; the grid is the blocks that fit the SMs at once (shared
    memory, and registers at the kernels' launch bounds), walking the
    tiles."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"axial_core takes float32 or bfloat16, got {dtype}")
    if c != groups * _GROUP_CHANNELS or groups < 1:
        raise ValueError(f"the kernels take {_GROUP_CHANNELS} channels per "
                         f"group, got C={c}, G={groups}")
    if not 1 <= length <= _MAX_LEN:
        raise ValueError(f"the kernels take 1 <= L <= {_MAX_LEN}, got "
                         f"L={length}")
    if nseq < 1:
        raise ValueError(f"no sequences: N={nseq}")
    esize = 2 if dtype == torch.bfloat16 else 4
    return TrainAttentionPlan(
        _core_plan(nseq, length, c, groups, esize, _FORWARD_POSITIONS, False,
                   sms),
        _core_plan(nseq, length, c, groups, esize, _BACKWARD_POSITIONS, True,
                   sms))


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _rows(ts: Sequence[torch.Tensor], names: Sequence[str]
          ) -> Tuple[List[torch.Tensor], int]:
    """Check ``[N, L, C]`` inputs of one device and dtype; return them with
    their common position stride ``ld`` when they share the strides
    ``(L * ld, ld, 1)`` (e.g. thirds of one ``[N, L, 3C]`` tensor) and the
    kernels' 16-byte loads can read them, else contiguous aligned copies
    and ``ld = C``."""
    n, length, c = ts[0].shape
    dev, dt = ts[0].device, ts[0].dtype
    for t, name in zip(ts, names):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (n, length, c):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {(n, length, c)} {dt} on "
                             f"{dev}")
    dtype_code(dt)
    if c % _GROUP_CHANNELS or not 1 <= length <= _MAX_LEN:
        raise ValueError(f"the kernels take L <= {_MAX_LEN} and "
                         f"{_GROUP_CHANNELS} channels per group, got "
                         f"L={length}, C={c}")
    ld = ts[0].stride(1)
    if (ld >= c and ld * ts[0].element_size() % 16 == 0
            and all(t.stride() == (length * ld, ld, 1) and _aligned(t)
                    for t in ts)):
        return list(ts), ld
    return [_contiguous(t) for t in ts], c


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` if contiguous and 16-byte aligned, else such a copy."""
    if t.is_contiguous() and _aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


class SumsPlan(NamedTuple):
    """The launches of ``csrc/logits_sums.cu``, forward and backward."""

    parts: int           # ranges of positions a (sequence, group) is cut in
    lanes: int           # lanes a (sequence, group): q and k, each range
    gslots: int          # the groups padded to a power of two
    seqs: int            # whole sequences a tile
    threads: int         # a block's threads: seqs x gslots x lanes
    tiles: int
    grid: int            # the forward's, persistent: at most
    #                      _SUMS_BLOCKS_PER_SM[0] x SMs; one row of fp32
    #                      partials a block in its workspace
    backward_grid: int   # the backward's: at most _SUMS_BLOCKS_PER_SM[1] x SMs


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _sums_tiles(nseq: int, gslots: int, parts: int) -> int:
    return -(-nseq // (_SUMS_THREADS // (2 * parts * gslots)))


def sums_plan_at(nseq: int, groups: int, parts: int, sms: int) -> SumsPlan:
    """The ``logits_sums`` launches with ``parts`` ranges of positions a
    lane (the choice :func:`sums_plan` makes; ``logits_sums_sweep.py``
    times each)."""
    gslots = _pow2(groups)
    seqs = _SUMS_THREADS // (2 * parts * gslots)
    tiles = _sums_tiles(nseq, gslots, parts)
    fwd, bwd = (min(tiles, b * sms) for b in _SUMS_BLOCKS_PER_SM)
    return SumsPlan(parts, 2 * parts, gslots, seqs, _SUMS_THREADS, tiles,
                    fwd, bwd)


@functools.lru_cache(maxsize=None)
def sums_plan(nseq: int, length: int, c: int, groups: int,
              dtype: torch.dtype, sms: int = SMS) -> SumsPlan:
    """The ``logits_sums`` launches on ``nseq`` sequences of ``length``
    positions, ``c = 8 groups`` channels.  Pure: the CPU tests hold it.

    A (sequence, group) takes 2 x ``parts`` lanes, q's and k's, each over
    one of ``parts`` ranges of its positions, summed with shuffles: the
    fewest ranges (1, 2 or 4, at most L) at which the tiles give at least
    half the SMs a block, else 4 (on an H100, the fastest in 23 of 24
    cases of ``logits_sums_sweep.py``: both kernels on each axis of both
    models at batch 256 and 64 and on 7 sequences).  A tile is the whole
    sequences a block of 256 lanes takes, the groups padded to a power of
    two; each grid is the blocks that fit the SMs at a kernel's launch
    bounds, walking the tiles."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits_sums takes float32 or bfloat16, got {dtype}")
    if c != groups * _GROUP_CHANNELS or not 1 <= groups <= _SUMS_THREADS // 2:
        raise ValueError(f"the kernels take {_GROUP_CHANNELS} channels per "
                         f"group and at most {_SUMS_THREADS // 2} groups, "
                         f"got C={c}, G={groups}")
    if not 1 <= length <= _MAX_LEN:
        raise ValueError(f"the kernels take 1 <= L <= {_MAX_LEN}, got "
                         f"L={length}")
    if nseq < 1:
        raise ValueError(f"no sequences: N={nseq}")
    gslots = _pow2(groups)
    most = min(1 << (length.bit_length() - 1), _SUMS_THREADS // (2 * gslots))
    allowed = [p for p in _SUMS_PARTS if p <= most]
    parts = next((p for p in allowed
                  if 2 * _sums_tiles(nseq, gslots, p) >= sms), allowed[-1])
    return sums_plan_at(nseq, groups, parts, sms)


# The forward's workspace by (device, stream, rows, columns): fp32 partials
# and the int32 count of blocks done, which the last block sets back to 0.
# The launches that share one are on one stream (a train step's), so they
# run one after another; a CUDA graph that launches the forward holds the
# workspace of its capture stream, made by an eager call before capture,
# and its replays must not overlap one another.
_WORKSPACE: Dict[Tuple[int, int, int, int],
                 Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(dev: torch.device, stream: int, rows: int, cols: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream, rows, cols)
    ws = _WORKSPACE.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "logits_sums_forward: no workspace for this stream and plan; "
                "call it once on the capture stream before capturing a CUDA "
                "graph")
        ws = _WORKSPACE[key] = (
            torch.empty((rows, cols), device=dev, dtype=torch.float32),
            torch.zeros((1,), device=dev, dtype=torch.int32))
    return ws


def _sums_plan(q: torch.Tensor, groups: int) -> SumsPlan:
    n, length, c = q.shape
    return sums_plan(n, length, c, groups, q.dtype,
                     sm_count(q.device.index or 0))


def _core_launch(q: torch.Tensor, scale: torch.Tensor
                 ) -> Tuple[TrainAttentionPlan, int]:
    g = scale.shape[0]
    check_tensor(scale, "scale", device=q.device, dtype=torch.float32,
                 shape=(g,))
    n, length, c = q.shape
    return train_attention_plan(n, length, c, g, q.dtype,
                                sm_count(q.device.index or 0)), g


def axial_core_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel: ``out [N, L, C]`` in q's dtype."""
    (q, k, v), ld = _rows((q, k, v), ("q", "k", "v"))
    plan, g = _core_launch(q, scale)
    fp = plan.forward
    n, length, c = q.shape
    dev, dt = q.device, q.dtype
    out = torch.empty((n, length, c), device=dev, dtype=dt)
    CORE_FORWARD.launch(dtype_code(dt), ptr(q), ptr(k), ptr(v), ld, ptr(out),
                        n, length, c, g, fp.seqs, fp.threads, fp.grid,
                        ptr(scale), _S(fp.smem), stream_ptr(dev))
    return out


def axial_core_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: torch.Tensor, dout: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """One launch of the backward kernel (and its float64 reduction of
    dscale): ``(dq, dk, dv)`` in q's dtype and ``dscale [G]`` fp32."""
    (q, k, v), ld = _rows((q, k, v), ("q", "k", "v"))
    plan, g = _core_launch(q, scale)
    bp = plan.backward
    dev, dt = q.device, q.dtype
    dout = _contiguous(dout)
    check_tensor(dout, "dout", device=dev, dtype=dt, shape=q.shape)
    n, length, c = q.shape
    dq, dk, dv = (torch.empty((n, length, c), device=dev, dtype=dt)
                  for _ in range(3))
    partial = torch.empty((bp.grid, g), device=dev, dtype=torch.float32)
    dscale = torch.empty((g,), device=dev, dtype=torch.float32)
    CORE_BACKWARD.launch(dtype_code(dt), ptr(q), ptr(k), ptr(v), ld,
                         ptr(dout), ptr(dq), ptr(dk), ptr(dv), n, length, c,
                         g, bp.seqs, bp.threads, bp.grid, ptr(scale),
                         ptr(partial), ptr(dscale), _S(bp.smem),
                         stream_ptr(dev))
    return dq, dk, dv, dscale


def logits_sums_forward(q: torch.Tensor, k: torch.Tensor,
                        groups: int) -> torch.Tensor:
    """One launch of the forward kernel, whose last block sums the blocks'
    partials in float64: ``[2, G]`` fp32."""
    (q, k), ld = _rows((q, k), ("q", "k"))
    dev = q.device
    p = _sums_plan(q, groups)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    partial, counter = _workspace(dev, stream, p.grid, 2 * groups)
    sums = torch.empty((2, groups), device=dev, dtype=torch.float32)
    n, length, c = q.shape
    SUMS_FORWARD.launch(dtype_code(q.dtype), ptr(q), ptr(k), ld, n, length,
                        c, groups, p.parts, p.seqs, p.threads, p.grid,
                        ptr(partial), ptr(counter), ptr(sums), _P(stream))
    return sums


def logits_sums_backward(q: torch.Tensor, k: torch.Tensor,
                         dsums: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel: ``(dq, dk)`` in q's dtype."""
    (q, k), ld = _rows((q, k), ("q", "k"))
    groups = dsums.shape[-1]
    dev, dt = q.device, q.dtype
    dsums = dsums.float().contiguous()
    check_tensor(dsums, "dsums", device=dev, dtype=torch.float32,
                 shape=(2, groups))
    p = _sums_plan(q, groups)
    n, length, c = q.shape
    dq, dk = (torch.empty((n, length, c), device=dev, dtype=dt)
              for _ in range(2))
    SUMS_BACKWARD.launch(dtype_code(dt), ptr(q), ptr(k), ld, ptr(dsums),
                         ptr(dq), ptr(dk), n, length, c, groups, p.parts,
                         p.seqs, p.threads, p.backward_grid, stream_ptr(dev))
    return dq, dk


class _AxialCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v, scale)
        return axial_core_forward(q, k, v, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return axial_core_backward(*ctx.saved_tensors, dout)


class _LogitsSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, groups):
        ctx.save_for_backward(q, k)
        return logits_sums_forward(q, k, groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, dsums):
        return (*logits_sums_backward(*ctx.saved_tensors, dsums), None)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device}")


def axial_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """``softmax_j(scale_g * q_i . k_j) @ v`` on ``[N, L, C]``,
    differentiable in q, k, v and ``scale [G]`` (fp32)."""
    if _on_cuda(q, "axial_core"):
        return _AxialCore.apply(q, k, v, scale)
    return axial_core_plain(q, k, v, scale)


def logits_sums(q: torch.Tensor, k: torch.Tensor,
                groups: int) -> torch.Tensor:
    """``[2, G]`` fp32: sum and sum of squares of the logits over
    (n, i, j), differentiable in q and k."""
    if _on_cuda(q, "logits_sums"):
        return _LogitsSums.apply(q, k, groups)
    return logits_sums_plain(q, k, groups)


def logits_moments_fused(q: torch.Tensor, k: torch.Tensor, groups: int,
                         count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch (mean, biased var) of the logits from :func:`logits_sums`;
    ``count = N * L * L``, this rank's.  The sums are all-reduced over the
    ranks (``parallel/mesh.py``), so the moments are the global batch's."""
    return _moments(*global_sums(logits_sums(q, k, groups), count))
