"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, and the statistics the end-to-end metrics take.

Serving (rows that can be checked one by one), over every row of the
requests kept:

* ``pose_rms``: ``|got - ref|`` over ``|ref - mean(ref)|`` in the L2 norm
  over all rows, the mean taken over the rows per keypoint coordinate:
  the error against how much the output varies from window to window;
* ``pose_max``: the same with the largest entry in place of the norm,
  which a single wrong row moves.  ``wiflow_mmfi`` reports it and does
  not compare it: its head reads one time step where ``wiflow`` averages
  twenty, and a sound run read 1.012 on it against the control's 1.01.

Training, over two stretches of three steps: the first steps of a run
(the reference from the same weights, batches and dropout draws) and
the three after the measured window (the reference from a copy of the
program's state then: parameters, running statistics, AdamW's moments
and the dropout generator); each number compared is the larger of the
two stretches':

* ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
* ``grad_gap``: the first step's gradient as the optimizer got it
  (AdamW's first moment after one step over ``1 - beta1``), leaf by
  leaf: ``| |g| - |g_ref| |`` over the larger of ``|g_ref|`` and the
  median leaf's ``|g_ref|``; the median leaf's gap is compared;
* ``change_gap``: the same for each parameter's change over the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's: their gradient is nought but for
  rounding (a conv bias a BatchNorm follows, the logits' BatchNorm
  shift under the softmax), and Adam moves them by the rounding alone;
* ``change_worst``: the largest of those leaves' gaps, which a fault in
  a few leaves moves where the median leaf does not;
* ``input_mean_gap``: the change over the three steps of the running
  mean of the BatchNorm that reads the input (the first in the module's
  order), ``|d - d_ref| / |d_ref|``.  Its batch means are means of
  zero-mean data, so a batch with rows left out moves them by as much
  as their size, where rounding moves them by a few thousandths: it
  catches a step that drops part of its batch, which at batch 2048 the
  loss shows only 1.4-8 times above rounding and every gradient number
  not at all.

Reported and not compared, because sound runs and the control or the
faults read alike on them (``PERF.md`` gives the readings): the first
step's loss gap, the worst leaf's gradient gap (``grad_worst``: the
reference itself, rounded to bf16, reads up to 1.6 on it), and
``grad_angle``, the median leaf's ``1 - cos`` between the two gradients.
A cell compares the numbers its file gives a limit.
"""

from __future__ import annotations

import math
import statistics
from typing import List, Mapping, Sequence

import torch

ROUNDING_LEAF = 1e-3


def exact_fp32() -> None:
    """float32 products and convolutions in full precision (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics (as
    ``statistics.quantiles(..., method="inclusive")``)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def pose_gaps(got: List[torch.Tensor], want: List[torch.Tensor]):
    """(compared numbers, reported ones)."""
    if not got:
        return {"pose_rms": math.inf, "pose_max": math.inf}, {}
    g = torch.cat([t.float().cpu() for t in got])
    w = torch.cat([t.float().cpu() for t in want])
    spread = w - w.mean(dim=0)
    return ({"pose_rms": ((g - w).norm() / spread.norm()).item(),
             "pose_max": ((g - w).abs().max() / spread.abs().max()).item()},
            {"rows_compared": g.shape[0], "requests_compared": len(got)})


def _leaf_gaps(got: Mapping[str, float], ref: Mapping[str, float]
               ) -> List[float]:
    med = statistics.median(ref.values())
    gaps = [abs(got[k] - ref[k]) / max(ref[k], med) for k in ref]
    return gaps if all(map(math.isfinite, gaps)) else [math.inf]


def _angles(got: Mapping[str, torch.Tensor],
            ref: Mapping[str, torch.Tensor], keys) -> List[float]:
    """``1 - cos`` between each leaf's two tensors (1 where one is 0)."""
    out = []
    for k in keys:
        a, b = got[k].double().flatten(), ref[k].double().flatten()
        den = a.norm() * b.norm()
        out.append(1.0 if den == 0 else (1.0 - (a @ b) / den).item())
    return out if all(map(math.isfinite, out)) else [math.inf]


def train_gaps(losses: Sequence[float], ref_losses: Sequence[float],
               grads: Mapping[str, torch.Tensor],
               ref_grads: Mapping[str, torch.Tensor],
               change: Mapping[str, torch.Tensor],
               ref_change: Mapping[str, torch.Tensor],
               input_mean: torch.Tensor, ref_input_mean: torch.Tensor):
    """(compared numbers, reported ones); ``input_mean``: the change of
    the input BatchNorm's running mean."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if len(losses) != len(ref_losses) or not all(map(math.isfinite, gaps)):
        gaps = [math.inf]

    def norms(d):
        return {k: v.double().norm().item() for k, v in d.items()}

    g, gr = norms(grads), norms(ref_grads)
    c, cr = norms(change), norms(ref_change)
    med = statistics.median(gr.values())
    moved = {k: cr[k] for k in gr if gr[k] >= ROUNDING_LEAF * med}
    grad, chg = _leaf_gaps(g, gr), _leaf_gaps(c, moved)
    d, dr = input_mean.double(), ref_input_mean.double()
    mean_gap = ((d - dr).norm() / dr.norm()).item()
    return ({"loss_gap": max(gaps), "grad_gap": statistics.median(grad),
             "change_gap": statistics.median(chg), "change_worst": max(chg),
             "input_mean_gap": mean_gap if math.isfinite(mean_gap)
             else math.inf},
            {"loss_gap_first": gaps[0], "grad_worst": max(grad),
             "grad_angle": statistics.median(_angles(grads, ref_grads,
                                                     moved)),
             "leaves_left_out": len(gr) - len(moved)})
