"""The port's stage-fused train path == the JAX package's, and == the
port's own stock-op path, on the CPU.

* Against JAX (fp32, dropout 0, weights through the port's
  ``wiflow_spec``): ``TCNStack`` with ``train_impl="fused"``, and the whole
  model at ``SMALL`` with ``tcn_train_impl = conv_train_impl = "fused"``
  on both sides (the JAX side through its Pallas stage kernels in interpret
  mode; batch 8, which its gates need): the train-mode output and the
  updated running statistics within 2e-4, every gradient within 1e-3.
* Within the port: one train step through the fused path against the same
  step through the stock-op path, with dropout **on** and one seed (both
  paths draw the same masks from ``dropout_generator``), at ``SMALL`` and at
  the default full width: loss, gradients, running statistics.
* The switches: eval mode ignores them, ``"auto"`` follows the device, a bad
  value raises, the ``state_dict`` keys do not depend on them.

Tolerances are relative to a leaf's largest entry, with the floors of
``tests/test_torch_train_step.py`` for leaves that are 0 in exact
arithmetic (a conv bias before a BatchNorm).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models.wiflow import TCNStack as JaxTCNStack
from wiflow_tpu.models.wiflow import WiFlowPoseModel as JaxModel
from wiflow_tpu.models.wiflow import fused_conv_gate

from tests.test_torch_harness import SMALL, TOL, nontrivial_stats, port_config
from wiflow_tpu_torch.core.config import ModelConfig, OptimConfig, use_fused
from wiflow_tpu_torch.models.layers import TorchBatchNorm
from wiflow_tpu_torch.models.torch_compat import (
    _get_path, load_state_dict, state_dict_from_jax, wiflow_spec,
)
from wiflow_tpu_torch.models.wiflow import TCNStack, WiFlowPoseModel
from wiflow_tpu_torch.ops.norm import batch_norm_train
from wiflow_tpu_torch.train.steps import create_train_state, train_step

GRAD_TOL = 1e-3
FUSED = dict(tcn_train_impl="fused", conv_train_impl="fused")


def _close(got, ref, tol, what, floor=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), floor, 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _close_leaves(got, ref, tol, what, floor_frac):
    floor = floor_frac * max(float(np.abs(np.asarray(r)).max())
                             for r in ref.values())
    for name in ref:
        _close(got[name], ref[name], tol, f"{what} {name}", floor)


def _tcn_state_dict(variables, cfg):
    """The ``tcn.*`` entries of the port's ``wiflow_spec`` from the
    variables of a bare JAX ``TCNStack``."""
    tree = {c: {"tcn": variables[c]} for c in ("params", "batch_stats")}
    return {key[len("tcn."):]: torch.from_numpy(np.ascontiguousarray(
        inv(np.asarray(_get_path(tree[coll], path), np.float32))))
        for key, coll, path, inv in wiflow_spec(cfg) if key.startswith("tcn.")}


def test_fused_tcn_stack_matches_jax():
    c0, chans, groups, batch, t = 60, (60, 40), 10, 8, 20
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, t, c0)).astype(np.float32)
    gv = (rng.standard_normal((batch, t, chans[-1])) * 0.1).astype(np.float32)
    jm = JaxTCNStack(num_inputs=c0, num_channels=chans, kernel_size=3,
                     groups=groups, dropout=0.0, train_impl="fused")
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)
    v = nontrivial_stats(jax.tree.map(np.asarray, v))

    def loss(params):
        y, st = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                         jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y * gv), (y, st)

    ref_grads, (ref_y, ref_st) = jax.grad(loss, has_aux=True)(v["params"])

    cfg = ModelConfig(num_subcarriers=c0, tcn_channels=chans,
                      tcn_groups=groups)
    port = TCNStack(c0, chans, 3, groups, 0.0, None, device="cpu",
                    train_impl="fused")
    load_state_dict(port, _tcn_state_dict(v, cfg))
    port.train()
    assert all(level.fused for level in port.network)
    y = port(torch.from_numpy(x))
    (y * torch.from_numpy(gv)).sum().backward()
    _close(y.detach(), ref_y, TOL, "output")
    after = _tcn_state_dict({"params": v["params"],
                             "batch_stats": ref_st["batch_stats"]}, cfg)
    got = port.state_dict()
    _close_leaves(got, {k: a for k, a in after.items() if "running" in k},
                  TOL, "running statistic", 1e-3)
    ref = _tcn_state_dict({"params": jax.tree.map(np.asarray, ref_grads),
                           "batch_stats": v["batch_stats"]}, cfg)
    grads = {n: p.grad for n, p in port.named_parameters()}
    _close_leaves(grads, {n: ref[n] for n in grads}, GRAD_TOL, "grad", 1e-2)


def test_fused_model_matches_jax_fused_model():
    batch = 8
    jcfg = JaxModelConfig(**SMALL, **FUSED, dropout=0.0, conv_dropout=0.0)
    # the JAX gates engage at this batch (they need a multiple of 8)
    assert fused_conv_gate(
        train=True, impl=jcfg.conv_train_impl,
        conv_channels=jcfg.conv_channels, w0=jcfg.tcn_channels[-1],
        r_rows=batch * jcfg.window_size) is not None
    model = JaxModel(jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((batch, jcfg.num_subcarriers,
                             jcfg.window_size)).astype(np.float32)
    gv = rng.standard_normal((batch, 15, 2)).astype(np.float32)
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(0)}, jnp.asarray(x))
    v = nontrivial_stats(jax.tree.map(np.asarray, v))

    @jax.jit
    def run(params):
        def loss(p):
            y, st = model.apply({"params": p,
                                 "batch_stats": v["batch_stats"]},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
            return jnp.sum(y * gv), (y, st)
        return jax.grad(loss, has_aux=True)(params)

    ref_grads, (ref_y, ref_st) = run(v["params"])

    cfg = port_config(jcfg)
    assert cfg.tcn_train_impl == cfg.conv_train_impl == "fused"
    port = load_state_dict(WiFlowPoseModel(cfg, device="cpu"),
                           state_dict_from_jax(v, cfg))
    port.train()
    y = port(torch.from_numpy(x))
    (y * torch.from_numpy(gv)).sum().backward()
    _close(y.detach(), ref_y, TOL, "output")
    after = state_dict_from_jax(
        {"params": v["params"],
         "batch_stats": jax.tree.map(np.asarray, ref_st["batch_stats"])}, cfg)
    got = port.state_dict()
    _close_leaves(got, {k: a for k, a in after.items() if "running" in k},
                  TOL, "running statistic", 1e-3)
    ref = state_dict_from_jax({"params": jax.tree.map(np.asarray, ref_grads),
                               "batch_stats": v["batch_stats"]}, cfg)
    # bn_similarity.bias cancels in the softmax: no gradient on either side
    grads = {n: p.grad for n, p in port.named_parameters()
             if p.grad is not None}
    assert len(grads) == len(list(port.parameters())) - 2
    _close_leaves(grads, {n: ref[n] for n in grads}, GRAD_TOL, "grad", 1e-2)


def _one_step(cfg, x, y, seed=7):
    state = create_train_state(cfg, OptimConfig(), seed=seed, device="cpu")
    m = train_step(state, x, y)
    model = state.model
    return (m, {n: p.grad for n, p in model.named_parameters()},
            {n: b for n, b in model.named_buffers() if "running" in n},
            model)


@pytest.mark.parametrize("kw,batch", [
    pytest.param(SMALL, 6, id="small"),
    pytest.param(dict(compute_dtype="float32"), 2, id="full-width"),
])
def test_fused_step_equals_stock_step_with_dropout_on(kw, batch):
    cfg = ModelConfig(**kw)
    assert cfg.dropout > 0 and cfg.conv_dropout > 0
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (batch, cfg.num_subcarriers, cfg.window_size)).astype(np.float32))
    y = torch.from_numpy((0.3 * np.tanh(rng.standard_normal(
        (batch, 15, 2)))).astype(np.float32))
    ms, gs, bs, stock = _one_step(cfg, x, y)
    mf, gf, bf, fused = _one_step(ModelConfig(**kw, **FUSED), x, y)
    assert not stock.tcn.network[0].fused and not stock.up.fused
    assert fused.tcn.network[0].fused and fused.up.fused
    for k in ("loss", "position", "bone", "mpe", "grad_norm"):
        _close(mf[k], ms[k], TOL, k)
    _close_leaves(gf, gs, GRAD_TOL, "grad", 1e-2)
    _close_leaves(bf, bs, TOL, "running statistic", 1e-3)
    # the same generator state afterwards: the same number of draws
    assert torch.equal(stock.dropout_generator.get_state(),
                       fused.dropout_generator.get_state())
    # a second seed draws other masks, so the masks do matter here
    m2 = _one_step(ModelConfig(**kw, **FUSED), x, y, seed=8)[0]
    assert abs(float(m2["loss"]) - float(mf["loss"])) > 1e-6


def test_eval_mode_ignores_the_switches():
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    stock = WiFlowPoseModel(ModelConfig(**SMALL), device="cpu",
                            generator=gen())
    fused = WiFlowPoseModel(ModelConfig(**SMALL, **FUSED), device="cpu",
                            generator=gen())
    assert list(stock.state_dict()) == list(fused.state_dict())
    assert not fused.training
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 40, 20)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(stock(x), fused(x))
    assert all(int(b) == 0 for n, b in fused.named_buffers()
               if n.endswith("num_batches_tracked"))


def test_switch_values():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ModelConfig().tcn_train_impl == ModelConfig().conv_train_impl == "xla"
    assert not use_fused("xla", cuda) and use_fused("fused", cpu)
    assert use_fused("auto", cuda) and not use_fused("auto", cpu)
    auto = WiFlowPoseModel(ModelConfig(**SMALL, tcn_train_impl="auto",
                                       conv_train_impl="auto"), device="cpu")
    assert not auto.tcn.network[0].fused and not auto.up.fused
    for name in ("tcn_train_impl", "conv_train_impl"):
        with pytest.raises(ValueError, match=name):
            ModelConfig(**{name: "pallas"})
    with pytest.raises(ValueError, match="pallas"):
        use_fused("pallas", cpu)
    with pytest.raises(ValueError, match="tcn_kernel_size"):
        WiFlowPoseModel(ModelConfig(**SMALL, tcn_kernel_size=5,
                                    tcn_train_impl="fused"), device="cpu")
    # the stock-op path takes that configuration
    WiFlowPoseModel(ModelConfig(**SMALL, tcn_kernel_size=5), device="cpu")


def test_bn_from_sums_reproduces_train_mode_bn():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 7, 6)).astype(np.float32)
                         * 2 + 1)
    a_bn, b_bn = TorchBatchNorm(6), TorchBatchNorm(6)
    for bn in (a_bn, b_bn):
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
            bn.bias.copy_(torch.linspace(-1, 1, 6))
        bn.train()
    xf = x.reshape(-1, 6)
    sums = torch.stack([xf.sum(0), (xf * xf).sum(0)])
    m, a, b = a_bn.from_sums(sums, xf.shape[0])
    ref = b_bn(x)
    torch.testing.assert_close((x - m) * a + b, ref, rtol=1e-5, atol=1e-5)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        torch.testing.assert_close(getattr(a_bn, name), getattr(b_bn, name),
                                   rtol=1e-6, atol=1e-6)
    y, _, _ = batch_norm_train(x, a_bn.weight, a_bn.bias, a_bn.running_mean,
                               a_bn.running_var)
    torch.testing.assert_close((x - m) * a + b, y, rtol=1e-5, atol=1e-5)
