"""The port's training slice as a whole == the JAX package, on the CPU.

* One train step of the port (``train/steps.py::train_step``: forward in
  train mode, pose loss, backward, clip, AdamW) against the JAX step
  (``make_step_fns(model, tx, mesh=None, scan=False)`` over a single
  batch), at ``SMALL`` and at the default full width, fp32, dropout at 0,
  weights carried across with ``state_dict_from_jax``, and at ``SMALL``
  with the batch split into 2 accumulated micro-batches: the loss and the
  step's metrics, every gradient leaf (JAX's from ``jax.grad`` of the same
  loss, averaged over the micro-batches and clipped by optax's rule), the
  updated running statistics and the updated parameters.
* A 2-epoch ``train_pose_model`` on small numpy data: the loss descends,
  the history has the JAX package's keys, the test metrics are finite;
  the trained ``state_dict`` loads into the flax model through the JAX
  package's ``from_torch_state_dict`` and its eval outputs agree.

Tolerances, relative to the reference leaf's largest entry: the loss,
metrics, outputs and running statistics 2e-4 (``TOL``), gradients 1e-3
(fp32 sums over the whole network in another order).  Where a leaf is
smaller than a thousandth of the largest running statistic, or than a
hundredth of the largest gradient, that is the scale instead: some leaves
are 0 in exact arithmetic and rounding noise as computed (a conv bias
before a BatchNorm; the 1x1 shortcut of the first conv block, whose one
input channel the BatchNorm after it normalizes away; the batch mean of a
BatchNorm'd input).  Adam's first step moves a parameter by about
``lr * sign(g)``, so parameters are held to ``2 * lr`` where a gradient
is near 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.core.config import OptimConfig as JaxOptimConfig
from wiflow_tpu.losses.pose_loss import pose_loss as jax_pose_loss
from wiflow_tpu.models.torch_compat import from_torch_state_dict
from wiflow_tpu.models.wiflow import WiFlowPoseModel as JaxModel
from wiflow_tpu.train.loop import HISTORY_KEYS
from wiflow_tpu.train.optim import make_optimizer as jax_make_optimizer
from wiflow_tpu.train.steps import TrainState as JaxTrainState
from wiflow_tpu.train.steps import make_step_fns

from tests.test_torch_harness import SMALL, TOL, jax_model, port_config
from wiflow_tpu_torch.core.config import Config, OptimConfig, TrainConfig
from wiflow_tpu_torch.models.torch_compat import (
    load_state_dict, state_dict_from_jax,
)
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.train.loop import train_pose_model
from wiflow_tpu_torch.train.optim import make_optimizer
from wiflow_tpu_torch.train.steps import TrainState, train_step

GRAD_TOL = 1e-3
LR = OptimConfig().lr


def _close(got, ref, tol, what, floor=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), floor, 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _data(rng, n, cfg):
    x = rng.standard_normal((n, cfg.num_subcarriers,
                             cfg.window_size)).astype(np.float32)
    y = 0.3 * np.tanh(x.mean(axis=2)[:, :30]).reshape(n, 15, 2)
    return x, y.astype(np.float32)


def _jax_step(model, v, x, y, accum):
    """The JAX step's new state and metrics, and the gradients of its loss
    (the mean over ``accum`` micro-batches)."""
    tx = jax_make_optimizer(JaxOptimConfig())
    train_loop, _ = make_step_fns(model, tx, mesh=None, scan=False,
                                  grad_accum_steps=accum)
    state = JaxTrainState(v["params"], v["batch_stats"],
                          tx.init(v["params"]))
    new_state, metrics = train_loop(state, jnp.asarray(x), jnp.asarray(y),
                                    jnp.arange(len(x))[None],
                                    jax.random.key(0))

    def loss(params, xb, yb):
        out, _ = model.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             xb, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(0)})
        return jax_pose_loss(out, yb)[0]

    grad = jax.jit(jax.grad(loss))
    mb = len(x) // accum
    grads = [grad(v["params"], jnp.asarray(x[i * mb:(i + 1) * mb]),
                  jnp.asarray(y[i * mb:(i + 1) * mb])) for i in range(accum)]
    grads = jax.tree.map(lambda *g: sum(g) / accum, *grads)
    return (jax.tree.map(np.asarray, new_state),
            jax.tree.map(np.asarray, metrics),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("kw,batch,accum", [
    pytest.param(SMALL, 4, 1, id="small"),
    pytest.param(dict(compute_dtype="float32"), 2, 1, id="full-width"),
    pytest.param(SMALL, 4, 2, id="small-accum2"),
])
def test_train_step_matches_jax(kw, batch, accum):
    jcfg = JaxModelConfig(**kw, dropout=0.0, conv_dropout=0.0)
    model, v = jax_model(jcfg)
    cfg = port_config(jcfg)
    x, y = _data(np.random.default_rng(0), batch, cfg)
    new_state, ref_m, ref_grads = _jax_step(model, v, x, y, accum)

    port = load_state_dict(WiFlowPoseModel(cfg, device="cpu"),
                           state_dict_from_jax(v, cfg))
    state = TrainState(port, make_optimizer(OptimConfig(),
                                            port.parameters()), 1.0)
    m = train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                   grad_accum_steps=accum)

    for k in ("loss", "position", "bone", "mpe", "pck", "pck50",
              "grad_norm"):
        _close(m[k], ref_m[k], TOL, k)
    # the port's .grad holds the clipped gradient
    norm = float(ref_m["grad_norm"])
    clip = 1.0 if norm < 1.0 else 1.0 / norm
    ref_sd = state_dict_from_jax({"params": jax.tree.map(
        lambda g: g * clip, ref_grads), "batch_stats": v["batch_stats"]},
        cfg)
    grads = dict(port.named_parameters())
    floor = 1e-2 * max(float(ref_sd[n].abs().max()) for n in grads)
    for name, p in grads.items():
        _close(p.grad, ref_sd[name], GRAD_TOL, f"grad {name}", floor)

    after = state_dict_from_jax({"params": new_state.params,
                                 "batch_stats": new_state.batch_stats}, cfg)
    got = port.state_dict()
    stats = [k for k in after if "running" in k]
    floor = 1e-3 * max(float(after[k].abs().max()) for k in stats)
    for k in stats:
        _close(got[k], after[k], TOL, k, floor)
    assert all(int(v) == accum for k, v in got.items()
               if k.endswith("num_batches_tracked"))
    for name in grads:
        err = (got[name] - after[name]).abs().max().item()
        assert err <= 2 * LR + 1e-6, (name, err)


def test_train_pose_model_descends_and_loads_into_flax():
    jcfg = JaxModelConfig(**SMALL)
    cfg = port_config(jcfg)
    rng = np.random.default_rng(1)
    splits = [_data(rng, n, cfg) for n in (96, 32, 32)]
    run = Config(model=cfg, train=TrainConfig(
        batch_size=16, num_epochs=2, optim=OptimConfig(lr=1e-3)))
    res = train_pose_model(*splits, run, device="cpu", verbose=False)
    assert tuple(res.history) == HISTORY_KEYS
    assert all(len(h) == 2 for h in res.history.values())
    assert res.history["train_loss"][1] < res.history["train_loss"][0]
    assert res.epochs_run == 2 and res.best_epoch in (0, 1)
    assert set(res.test_metrics) == {"loss", "mpe", "pck@0.1", "pck@0.2",
                                     "pck@0.3", "pck@0.4", "pck@0.5"}
    assert all(np.isfinite(v) for v in res.test_metrics.values())
    assert res.predictions.shape == res.targets.shape == (32, 15, 2)

    x = splits[2][0][:5]
    port = load_state_dict(WiFlowPoseModel(cfg, device="cpu"),
                           res.state_dict)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    flax_vars = from_torch_state_dict(res.state_dict, jcfg)
    ref = np.asarray(JaxModel(jcfg).apply(flax_vars, jnp.asarray(x),
                                          train=False))
    _close(out, ref, TOL, "flax eval of the trained weights")
