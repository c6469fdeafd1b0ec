"""Model complexity: parameters and FLOPs (thop-style reporting).

Counterpart of ``wiflow_tpu/utils/flops.py``.  The reference profiles its
models with ``thop`` (ref baseline/WiSPPN/wisppn.py:927-950,
cross_dataset_test/HPE-Li/comlexity.py).  ``flop_count`` is the
counterpart of ``jaxpr_flops``: torch's ``FlopCounterMode`` counts 2 x the
multiply-adds of every product and convolution of one eval forward;
elementwise work is not counted, as neither does the JAX count.
``xla_flops`` (XLA's cost analysis of a compiled forward) has none.

Where the two counts differ: ``jax.image.resize`` lowers to products that
``jaxpr_flops`` counts, while ``F.interpolate`` is no product to torch.
``resize_flops`` counts the port's bilinear resizes as the JAX package's
one-axis-at-a-time products would (the cheaper of the two axis orders,
2 x MACs), so that ``flop_count + resize_flops`` is the JAX count of a
model that resizes (WiSPPN, PerUnet, WPformer); for WiFlow and HPE-Li,
which do not, ``flop_count`` alone is.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

_UPSAMPLE = torch.ops.aten.upsample_bilinear2d


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _resize_formula(x_shape, output_size, *args, out_shape=None, **kwargs):
    n, c, h, w = x_shape
    h2, w2 = out_shape[-2:]
    # contract H then W, or W then H: 2 x MACs of the cheaper order
    return 2 * n * c * min(h * h2 * w + h2 * w * w2,
                           w * w2 * h + w2 * h * h2)


def _count(model: nn.Module, x: torch.Tensor, mapping=None) -> int:
    was = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False,
                                              custom_mapping=mapping) as fc:
            model(x)
    finally:
        model.train(was)
    return fc.get_total_flops()


def flop_count(model: nn.Module, x: torch.Tensor) -> int:
    """FLOPs (2 x MACs of products and convolutions) of one eval forward
    of ``model`` on ``x``, for the whole batch."""
    return _count(model, x)


def resize_flops(model: nn.Module, x: torch.Tensor) -> int:
    """The bilinear resizes of one eval forward on ``x``, counted as the
    JAX package's ``jax.image.resize`` products (module docstring)."""
    zero = {op: (lambda *a, **k: 0) for op in
            (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
             torch.ops.aten.baddbmm, torch.ops.aten.convolution,
             torch.ops.aten._convolution, torch.ops.aten.matmul)}
    return _count(model, x, {**zero, _UPSAMPLE: _resize_formula})


def profile_model(model: nn.Module, sample_x: torch.Tensor
                  ) -> Dict[str, Any]:
    """Parameters and FLOPs/MACs a sample of ``model``."""
    flops = flop_count(model, sample_x)
    batch = sample_x.shape[0]
    params = count_params(model)
    return {
        "params": params,
        "params_m": params / 1e6,
        "flops_per_sample": flops / batch,
        "gflops_per_sample": flops / batch / 1e9,
        "gmacs_per_sample": flops / batch / 2e9,       # thop-style
    }
