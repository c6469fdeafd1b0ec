"""The port's training pieces == the JAX package's, on the CPU, fp32.

Train-mode BatchNorm and its running update, the pose loss, PCK and
MPJPE, the optimizer with its clip, and the host-side schedules get the
same numpy inputs as their JAX counterparts.  Dropout masks cannot match
(JAX's PRNG against torch's Philox), so dropout is held to its
distribution: the keep rate within a binomial bound, the 1/keep scaling,
the channel mask shared over (H, W), the same mask for the same seed.

Tolerances: values 2e-4 (``TOL``) relative to their largest entry; the
optimizer's parameters 1e-6 relative (the same fp32 arithmetic in another
order, over 3 steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wiflow_tpu.core.config import LossConfig as JaxLossConfig
from wiflow_tpu.core.config import OptimConfig as JaxOptimConfig
from wiflow_tpu.losses.pose_loss import pose_loss as jax_pose_loss
from wiflow_tpu.metrics.metrics import mpjpe as jax_mpjpe
from wiflow_tpu.metrics.metrics import (
    pck_correct_fractions as jax_pck,
)
from wiflow_tpu.ops.norm import batch_norm_train as jax_bn_train
from wiflow_tpu.train import loop as jax_loop
from wiflow_tpu.train import optim as jax_optim

from tests.test_torch_harness import TOL
from wiflow_tpu_torch.core.config import LossConfig, OptimConfig
from wiflow_tpu_torch.losses.pose_loss import pose_loss
from wiflow_tpu_torch.metrics.metrics import mpjpe, pck_correct_fractions
from wiflow_tpu_torch.models.layers import (
    TorchBatchNorm, TorchDropout, TorchDropout2d,
)
from wiflow_tpu_torch.ops.norm import batch_norm_train, dropout, dropout2d
from wiflow_tpu_torch.train import loop, optim


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# BatchNorm, dropout
# ---------------------------------------------------------------------------

def test_batch_norm_train_and_running_update_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 7, 12)) * 2 + 0.5).astype(np.float32)
    gamma, beta, rm = (rng.standard_normal(12).astype(np.float32)
                       for _ in range(3))
    rv = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)

    (ry, rmean, rvar), vjp = jax.vjp(
        lambda a, g, b: jax_bn_train(a, g, b, jnp.asarray(rm),
                                     jnp.asarray(rv)),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    rdx, rdg, rdb = vjp((jnp.asarray(dy), jnp.zeros(12), jnp.zeros(12)))

    tx, tg, tb = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, gamma, beta))
    y, new_mean, new_var = batch_norm_train(
        tx, tg, tb, torch.from_numpy(rm), torch.from_numpy(rv))
    y.backward(torch.from_numpy(dy))
    for what, got, ref in (("y", y.detach(), ry), ("mean", new_mean, rmean),
                           ("var", new_var, rvar), ("dx", tx.grad, rdx),
                           ("dgamma", tg.grad, rdg), ("dbeta", tb.grad, rdb)):
        _close(got, ref, what=what)

    bn = TorchBatchNorm(12, device="cpu").train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rm))
        bn.running_var.copy_(torch.from_numpy(rv))
    bn(torch.from_numpy(x))
    _close(bn.running_mean, rmean, what="module running_mean")
    _close(bn.running_var, rvar, what="module running_var")
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("rate", [0.3, 0.5])
def test_dropout_keep_rate_scaling_and_seed(rate):
    keep = 1.0 - rate
    n = 200_000
    x = torch.ones(n)
    y = dropout(x, rate, torch.Generator().manual_seed(1))
    kept = (y != 0).double().mean().item()
    # within 5 standard deviations of a Binomial(n, keep) fraction
    assert abs(kept - keep) < 5 * np.sqrt(keep * rate / n), kept
    assert set(torch.unique(y).tolist()) == {0.0, (x[:1] / keep).item()}
    again = dropout(x, rate, torch.Generator().manual_seed(1))
    other = dropout(x, rate, torch.Generator().manual_seed(2))
    assert torch.equal(y, again) and not torch.equal(y, other)
    assert dropout(x, 0.0, None) is x


@pytest.mark.parametrize("rate", [0.3, 0.5])
def test_dropout2d_shares_the_mask_over_h_and_w(rate):
    keep = 1.0 - rate
    b, h, w, c = 256, 5, 6, 64
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        1.0, 2.0, (b, h, w, c)).astype(np.float32))
    y = dropout2d(x, rate, torch.Generator().manual_seed(3))
    kept = y != 0
    # one keep bit per (sample, channel)
    assert torch.equal(kept, kept[:, :1, :1, :].expand_as(kept))
    frac = kept[:, 0, 0, :].double().mean().item()
    assert abs(frac - keep) < 5 * np.sqrt(keep * rate / (b * c)), frac
    torch.testing.assert_close(y[kept], x[kept] / keep, rtol=0, atol=0)
    again = dropout2d(x, rate, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)


def test_dropout_modules_are_identity_in_eval():
    x = torch.randn(4, 3, 5, 8)
    gen = torch.Generator().manual_seed(0)
    for m in (TorchDropout(0.5, gen), TorchDropout2d(0.5, gen)):
        assert m.eval()(x) is x
        assert not torch.equal(m.train()(x), x)


# ---------------------------------------------------------------------------
# loss and metrics
# ---------------------------------------------------------------------------

def _poses(seed, b=9):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, (b, 15, 2)).astype(np.float32)
    p = (t + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)
    return p, t


@pytest.mark.parametrize("loss_type", ["smooth_l1", "mse", "l1"])
def test_pose_loss_matches_jax(loss_type):
    p, t = _poses(1)
    ref, ref_parts = jax_pose_loss(jnp.asarray(p), jnp.asarray(t),
                                   JaxLossConfig(loss_type=loss_type))
    got, parts = pose_loss(torch.from_numpy(p), torch.from_numpy(t),
                           LossConfig(loss_type=loss_type))
    _close(got, ref, what="total")
    for k in ("position", "bone"):
        _close(parts[k], ref_parts[k], what=k)
    # the reference's [B, 30] layout
    flat, _ = pose_loss(torch.from_numpy(p.reshape(9, 30)),
                        torch.from_numpy(t.reshape(9, 30)),
                        LossConfig(loss_type=loss_type))
    assert float(flat) == float(got)


def test_pck_and_mpjpe_match_jax():
    p, t = _poses(2, b=32)
    t[3, 12] = t[3, 2]            # torso of length 0: the 0.01 clamp
    thr = (0.1, 0.2, 0.3, 0.4, 0.5)
    _close(pck_correct_fractions(torch.from_numpy(p), torch.from_numpy(t),
                                 thr),
           jax_pck(jnp.asarray(p), jnp.asarray(t), thr), what="pck")
    _close(mpjpe(torch.from_numpy(p), torch.from_numpy(t)),
           jax_mpjpe(jnp.asarray(p), jnp.asarray(t)), what="mpjpe")


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_norm", [0.5, 3.0])
def test_adamw_with_clip_matches_optax(grad_norm):
    """Three steps on identical parameters and gradients; the gradient norm
    below or above the clip of 1.0.  Leaf ``c`` gets no gradient on the
    torch side (as ``bn_similarity.bias``) and zeros on the optax side."""
    cfg = dict(lr=1e-2, weight_decay=5e-5)
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": (7,), "c": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jax_optim.make_optimizer(JaxOptimConfig(**cfg))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = optim.make_optimizer(OptimConfig(**cfg), tparams.values())
    for step in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        grads["c"] = np.zeros(shapes["c"], np.float32)
        total = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                            for g in grads.values()))
        grads = {k: (g * grad_norm / total).astype(np.float32)
                 for k, g in grads.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

        for k, p in tparams.items():
            p.grad = None if k == "c" else torch.from_numpy(grads[k].copy())
        norm = optim.apply_gradients(opt, 1.0)
        _close(norm, optax.global_norm(grads), 1e-6, f"norm step {step}")
        for k in shapes:
            _close(tparams[k].detach(), jparams[k], 1e-6, f"{k} step {step}")


def test_learning_rate_and_unported_kinds():
    p = [torch.nn.Parameter(torch.zeros(3))]
    opt = optim.make_optimizer(OptimConfig(), p)
    assert optim.get_learning_rate(opt) == 1e-4
    optim.set_learning_rate(opt, 5e-5)
    assert optim.get_learning_rate(opt) == 5e-5
    for kind, cls in (("adam", torch.optim.Adam), ("sgd", torch.optim.SGD)):
        assert isinstance(optim.make_optimizer(OptimConfig(kind=kind), p), cls)
    with pytest.raises(ValueError, match="unknown optimizer kind"):
        optim.make_optimizer(OptimConfig(kind="lion"), p)


def test_plateau_early_stop_and_patience_match_jax():
    metrics = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.8, 0.85, 0.86,
               0.87, 0.88, 0.89, 0.9, 0.9, 0.9, 0.9]
    ref = jax_optim.ReduceLROnPlateau.from_config(JaxOptimConfig())
    got = optim.ReduceLROnPlateau.from_config(OptimConfig())
    ref_stop = jax_optim.EarlyStopping(patience=5)
    stop = optim.EarlyStopping(patience=5)
    for epoch, m in enumerate(metrics):
        assert got.step(m) == ref.step(m)
        assert stop.update(m, epoch) == ref_stop.update(m, epoch)
        assert stop.should_stop == ref_stop.should_stop
    for port, jax_obj in ((got, ref), (stop, ref_stop)):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(jax_obj, f.name), f.name
    assert got.lr < OptimConfig().lr
    for args in ((3, 11811, 46), (3, 11811, 3937), (5, None, 10),
                 (5, 0, 10), (2, 7, 3)):
        assert loop.scaled_patience(*args) == jax_loop.scaled_patience(*args)


@pytest.mark.parametrize("schedule", ["linear_decay", "multistep", "plateau"])
def test_epoch_schedules_match_jax(schedule):
    for epoch in range(0, 61, 3):
        assert optim.epoch_schedule_lr(OptimConfig(schedule=schedule),
                                       epoch) == \
            jax_optim.epoch_schedule_lr(JaxOptimConfig(schedule=schedule),
                                        epoch)
