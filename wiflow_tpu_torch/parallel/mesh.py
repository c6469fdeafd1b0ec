"""Data-parallel training over ranks: one process a rank, a device each.

Counterpart of ``wiflow_tpu/parallel/mesh.py``.  The JAX package lays a
1-D ``('data',)`` mesh over its devices, shards each global batch over
it, replicates the state and lets XLA insert the collectives; because its
BatchNorm moments are taken over the global batch, an N-device run is
the one-device run on the same global batch.  Here a rank is a process
of ``torch.distributed`` (NCCL on CUDA, gloo on the CPU; the ranks meet
through a file, so no port is opened), and within the trainer's steps
(:func:`data_parallel`, which ``train/steps.py`` enters) the same holds:

  * every rank holds the whole splits and builds the same index tables
    from the same seed; rank r takes rows ``[r B/W, (r+1) B/W)`` of each
    global batch (:func:`local_rows`), after the batch's augmentation;
    a dropout mask is drawn for the global batch and sliced the same way;
  * the per-channel sums behind every train-mode BatchNorm, and the
    attention logits' sums, are all-reduced where they are formed
    (:func:`global_sums`; differentiable, its backward all-reduces the
    cotangent), so the moments and the running statistics are the global
    batch's;
  * gradients are averaged over the ranks before the clip
    (:func:`average_gradients`): each rank's loss is its rows' mean, so
    the average is the gradient of the global batch's mean loss;
  * metrics are averaged over the ranks (:func:`mean_over_ranks`) and
    predictions gathered in the global batch's order
    (:func:`gather_batches`).

Outside :func:`data_parallel`, or without a process group, the functions
that the model's layers reach (:func:`local_rows`, :func:`global_sums`,
:func:`step_world`) are the identity and a rank computes by itself, as
one process would: work a rank repeats on its own data outside the
trainer (the denoising autoencoders' pre-training) reduces nothing.  The
trainer's own collectives (:func:`average_gradients`,
:func:`mean_over_ranks`, :func:`gather_batches`) act whenever a group is
up; without one they too are the identity.
:func:`spawn` starts a command's ranks; asking for more CUDA ranks than
there are CUDA devices raises (:func:`resolve_world`) and a rank that
fails fails the command.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_IN_STEP = False


def is_initialized() -> bool:
    """A process group is up."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The number of ranks: 1 without a process group."""
    return dist.get_world_size() if is_initialized() else 1


@contextlib.contextmanager
def data_parallel():
    """A step of the data-parallel trainer: within the block, when a
    process group is up, the batch is the global one (:func:`local_rows`,
    :func:`global_sums`, :func:`step_world`)."""
    global _IN_STEP
    prev, _IN_STEP = _IN_STEP, True
    try:
        yield
    finally:
        _IN_STEP = prev


def step_world() -> int:
    """The ranks the running step spans: the process group's inside
    :func:`data_parallel`, else 1."""
    return world_size() if _IN_STEP else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the one rank that prints and writes files."""
    return rank() == 0


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def resolve_world(num_devices: Optional[int], device=None) -> int:
    """The ranks that ``MeshConfig(num_devices)`` asks for on ``device``
    (``"cuda"`` unless ``"cpu"``): None is every CUDA device (one process
    on the CPU).  More CUDA ranks than CUDA devices raise ``ValueError``;
    on the CPU any count runs, as gloo processes."""
    dev = torch.device("cuda" if device is None else device)
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"num_devices={num_devices}: at least 1")
    if dev.type != "cuda":
        return num_devices or 1
    have = torch.cuda.device_count()
    want = have if num_devices is None else num_devices
    if want > 1 and want > have:
        raise ValueError(
            f"{want} ranks asked for on CUDA: more ranks than devices "
            f"({have} CUDA device(s)); nothing runs on fewer")
    return max(want, 1)


def mesh_world(num_devices: Optional[int], device) -> int:
    """The world a trainer runs in, checked against ``MeshConfig``: the
    process group's size (``num_devices`` None or equal to it), else 1.
    Outside a process group None is this one process (the CLIs that take
    every device resolve None themselves and :func:`spawn` the ranks), and
    a count of several ranks raises: they are started by :func:`spawn`."""
    if is_initialized():
        if num_devices not in (None, world_size()):
            raise ValueError(
                f"MeshConfig(num_devices={num_devices}) in a process group "
                f"of {world_size()} ranks")
        return world_size()
    if num_devices is None:
        return 1
    want = resolve_world(num_devices, device)
    if want > 1:
        raise ValueError(
            f"MeshConfig(num_devices={num_devices}) asks for {want} ranks "
            f"and no process group is up: start them with "
            f"wiflow_tpu_torch.parallel.mesh.spawn")
    return 1


def init(rank_: int, world: int, device, store: str) -> None:
    """Join the process group as ``rank_`` of ``world`` on ``device``
    (rank r takes CUDA device r), meeting through the file ``store``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}",
                            world_size=world, rank=rank_)


@contextlib.contextmanager
def process_group(world: int = 1, device=None, rank_: int = 0):
    """The process group around a block, in this process (rank ``rank_``
    of ``world``), on a store of its own; torn down after it."""
    with tempfile.TemporaryDirectory() as tmp:
        init(rank_, world, device or "cuda", os.path.join(tmp, "store"))
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank_: int, world: int, device: str, store: str,
               fn: Callable, args: Tuple) -> None:
    if rank_:
        sys.stdout = open(os.devnull, "w", encoding="utf-8")
    init(rank_, world, device, store)
    try:
        rc = fn(*args)
    finally:
        dist.destroy_process_group()
    if rc:
        raise SystemExit(rc)


def spawn(fn: Callable, world: int, device, *args) -> None:
    """Run ``fn(*args)`` in ``world`` new processes, each a rank of one
    process group on ``device`` (rank r on CUDA device r), and wait for
    them.  Only rank 0's standard output is kept.  A rank that fails (or
    whose ``fn`` returns a nonzero code) ends the others and raises here.
    ``fn`` must be picklable (a module-level function)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, str(torch.device(device or "cuda")),
                       os.path.join(tmp, "store"), fn, args))


def run(fn: Callable, world: int, device, *args) -> int:
    """``fn(*args)``'s exit code, run here when ``world`` is 1, else in
    :func:`spawn`'s ranks (0 once they all end well): what a CLI's
    ``main`` calls."""
    if world == 1:
        return fn(*args)
    spawn(fn, world, device, *args)
    return 0


@contextlib.contextmanager
def main_first():
    """Rank 0 runs the block first (it writes the caches, the synthetic
    data); the others run it after, and find them."""
    if not is_initialized():
        yield
        return
    if not is_main():
        dist.barrier()
    yield
    if is_main():
        dist.barrier()


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch: ``[r n/W, (r+1) n/W)``, W the
    :func:`step_world`."""
    w = step_world()
    if w == 1:
        return x
    n = x.shape[0]
    if n % w:
        raise ValueError(f"a batch of {n} rows does not split over {w} "
                         f"ranks: make it a multiple, "
                         f"{pad_to_multiple(n, w)}")
    k = n // w
    return x[rank() * k:(rank() + 1) * k]


def global_sums(sums: torch.Tensor, count: int) -> Tuple[torch.Tensor, int]:
    """Per-channel sums over this rank's ``count`` elements -> the sums and
    the count over every rank of the step (:func:`data_parallel`),
    differentiable in ``sums``."""
    if not (_IN_STEP and is_initialized()):
        return sums, count
    return _AllReduceSum.apply(sums), count * world_size()


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the same sum of the
    cotangents (every rank's loss depends on every rank's sums)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def average_gradients(params: Sequence[torch.nn.Parameter]) -> None:
    """Every parameter's gradient replaced by its mean over the ranks, in
    one all-reduce."""
    if not is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    flat.div_(world_size())
    for g, f in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(f)


def mean_over_ranks(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the ranks (each rank's the mean over as
    many rows), in one all-reduce."""
    if not is_initialized():
        return m
    keys = list(m)
    flat = torch.cat([m[k].reshape(-1).float() for k in keys])
    dist.all_reduce(flat)
    flat.div_(world_size())
    out, at = {}, 0
    for k in keys:
        n = m[k].numel()
        out[k] = flat[at:at + n].reshape(m[k].shape).to(m[k].dtype)
        at += n
    return out


def gather_batches(t: torch.Tensor, batches: int) -> torch.Tensor:
    """This rank's rows of ``batches`` global batches, concatenated
    (``[batches * b, ...]``) -> every rank's, in the global batches'
    order (``[batches * b * W, ...]``)."""
    w = world_size()
    if w == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(w)]
    dist.all_gather(parts, t.contiguous())
    per = [p.reshape(batches, -1, *t.shape[1:]) for p in parts]
    return torch.stack(per, dim=1).reshape(-1, *t.shape[1:])
