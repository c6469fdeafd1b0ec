"""Port train-mode attention modules == the flax modules, CPU, fp32.

Train-mode ``AxialAttention`` and ``DualAxialAttention``: output,
parameter gradients and updated running statistics against the flax
modules with ``train_impl="fused"`` (Pallas, interpret mode) and
``"xla"``, at the shapes of ``tests/test_attention_train.py``.

The loss is ``sum(out * r)`` with a fixed random ``r``: the output
BatchNorm makes ``sum(out ** 2)`` nearly constant, and gradients of a
constant are all cancellation.

Tolerances, each relative to the largest entry of the reference leaf or
to a thousandth of the module's largest leaf of the same kind, whichever
is larger: output and running statistics 2e-4 (``TOL``), gradients 1e-3.
The floor is for leaves whose exact value is 0: a bias that feeds a
BatchNorm has no gradient, and a BatchNorm'd input has a batch mean of 0,
so what is computed there is rounding noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.models.wiflow import AxialAttention as JaxAxial
from wiflow_tpu.models.wiflow import DualAxialAttention as JaxDual

from tests.test_torch_harness import TOL
from wiflow_tpu_torch.models.wiflow import AxialAttention, DualAxialAttention

GRAD_TOL = 1e-3
C, G = 16, 4


def _close(got, ref, tol, what, floor=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), floor, 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"



def _axis_state_dict(params, stats=None, prefix=""):
    """One flax AxialAttention tree under the reference torch names."""
    sd = {f"{prefix}qkv_transform.weight": np.asarray(
        params["qkv_weight"]).T[:, :, None]}
    for bn in ("bn_qkv", "bn_similarity", "bn_output"):
        sd[f"{prefix}{bn}.weight"] = params[bn]["weight"]
        sd[f"{prefix}{bn}.bias"] = params[bn]["bias"]
        if stats is not None:
            sd[f"{prefix}{bn}.running_mean"] = stats[bn]["running_mean"]
            sd[f"{prefix}{bn}.running_var"] = stats[bn]["running_var"]
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def _dual_state_dict(params, stats=None):
    sd = {}
    for axis in ("width_axis", "height_axis"):
        sd.update(_axis_state_dict(params[axis],
                                   None if stats is None else stats[axis],
                                   f"{axis}."))
    return sd


def _jax_train(module, v, x, r):
    def loss(params):
        out, mut = module.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * r), (out, mut)

    (_, (out, mut)), grads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    return (np.asarray(out), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, mut["batch_stats"]))


def _port_train(module, x, r):
    module.train()
    out = module(torch.from_numpy(x))
    (out * torch.from_numpy(r)).sum().backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in module.named_parameters()}
    return out.detach(), grads, module.state_dict()


def _check_module(out, grads, state, ref_out, ref_grads, ref_stats):
    _close(out, ref_out, TOL, "output")
    assert set(ref_grads) == set(grads)
    floor = 1e-3 * max(float(g.abs().max()) for g in ref_grads.values())
    for name, ref in ref_grads.items():
        _close(grads[name], ref, GRAD_TOL, f"grad {name}", floor)
    stats = {k: v for k, v in ref_stats.items() if "running" in k}
    floor = 1e-3 * max(float(v.abs().max()) for v in stats.values())
    for name, ref in stats.items():
        _close(state[name], ref, TOL, name, floor)


@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("width", [True, False])
def test_axis_train_matches_flax(width, impl):
    rng = np.random.default_rng(0 if width else 1)
    x, r = (rng.standard_normal((3, 5, 6, C)).astype(np.float32)
            for _ in range(2))
    ref_mod = JaxAxial(C, C, groups=G, width=width, train_impl=impl)
    v = jax.tree.map(np.asarray, JaxAxial(C, C, groups=G, width=width)
                     .init({"params": jax.random.key(0)}, jnp.asarray(x),
                           train=False))
    ref_out, ref_grads, ref_stats = _jax_train(ref_mod, v, x, r)

    port = AxialAttention(C, G, width, device="cpu")
    port.load_state_dict(_axis_state_dict(v["params"], v["batch_stats"]),
                         strict=False)
    out, grads, state = _port_train(port, x, r)
    _check_module(out, grads, state, ref_out,
                  _axis_state_dict(ref_grads), _axis_state_dict(
                      v["params"], ref_stats))
    assert int(state["bn_similarity.num_batches_tracked"]) == 1
    assert grads["bn_similarity.bias"].abs().max() == 0


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_dual_train_matches_flax(impl):
    rng = np.random.default_rng(2)
    x, r = (rng.standard_normal((2, 5, 4, C)).astype(np.float32)
            for _ in range(2))
    v = jax.tree.map(np.asarray, JaxDual(C, groups=G).init(
        {"params": jax.random.key(0)}, jnp.asarray(x), train=False))
    ref_out, ref_grads, ref_stats = _jax_train(
        JaxDual(C, groups=G, train_impl=impl), v, x, r)

    port = DualAxialAttention(C, G, device="cpu")
    port.load_state_dict(_dual_state_dict(v["params"], v["batch_stats"]),
                         strict=False)
    out, grads, state = _port_train(port, x, r)
    _check_module(out, grads, state, ref_out, _dual_state_dict(ref_grads),
                  _dual_state_dict(v["params"], ref_stats))
