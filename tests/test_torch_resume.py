"""Resume, schedules and optimizers of the port's trainer, on the CPU.

* ``ReduceLROnPlateau`` and ``EarlyStopping`` in both modes, on drawn
  metric sequences: the same lr and stop decisions as the JAX classes
  (exactly: host floats, same arithmetic), and a ``state_dict`` round
  trip mid-sequence changes nothing.
* ``adam`` and ``sgd`` (momentum 0.9 and 0): three steps equal optax's on
  the same gradients to 1e-6 relative (fp32 in another order).
* ``frozen_params``: the frozen leaves stay exactly as they were (under
  AdamW they still decay by the weight decay, which optax adds after the
  mask: held to optax like the rest), the clip norm leaves them out, and
  every leaf follows optax's masked chain to 1e-6.
* ``train_pose_model``: a small model with dropout and augmentation on,
  3 epochs straight against 2 epochs and a resume to 3: history, best
  weights, final weights and test metrics bit-equal.  ``monitor="pck"``
  keeps the epoch of the largest val PCK; ``data_dtype="bfloat16"`` stages
  bf16 CSI.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wiflow_tpu.core.config import OptimConfig as JaxOptimConfig
from wiflow_tpu.train import optim as jax_optim

from tests.test_torch_harness import SMALL
from wiflow_tpu_torch.core.checkpoint import load_checkpoint
from wiflow_tpu_torch.core.config import (
    Config, ModelConfig, OptimConfig, TrainConfig,
)
from wiflow_tpu_torch.train import loop, optim
from wiflow_tpu_torch.train.steps import create_train_state

OPT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pool in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _metric_sequence(seed, n=24):
    """A noisy descending (or, negated, ascending) metric with plateaus."""
    rng = np.random.default_rng(seed)
    base = 1.0 - np.cumsum(rng.exponential(0.02, n)) * (rng.random(n) < 0.5)
    return [float(v) for v in base + 0.01 * rng.standard_normal(n)]


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedules_match_jax_in_both_modes(mode, seed):
    seq = _metric_sequence(seed)
    if mode == "max":
        seq = [-v for v in seq]
    cfg = dict(lr=1e-3, plateau_patience=2)
    ref = jax_optim.ReduceLROnPlateau.from_config(JaxOptimConfig(**cfg),
                                                  mode=mode)
    got = optim.ReduceLROnPlateau.from_config(OptimConfig(**cfg), mode=mode)
    ref_stop = jax_optim.EarlyStopping(patience=4, mode=mode)
    stop = optim.EarlyStopping(patience=4, mode=mode)
    lrs = set()
    for epoch, m in enumerate(seq):
        assert got.step(m) == ref.step(m)
        assert stop.update(m, epoch) == ref_stop.update(m, epoch)
        assert stop.should_stop == ref_stop.should_stop
        lrs.add(got.lr)
        if epoch == len(seq) // 2:
            # a resume mid-sequence: fresh objects from the state dicts
            got2 = optim.ReduceLROnPlateau(lr=0.0)
            got2.load_state_dict(got.state_dict())
            stop2 = optim.EarlyStopping()
            stop2.load_state_dict(stop.state_dict())
            assert got2 == got and stop2 == stop
            got, stop = got2, stop2
    assert got.state_dict() == ref.state_dict()
    assert stop.state_dict() == ref_stop.state_dict()
    assert len(lrs) > 1, "the sequence never cut the lr"


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

SHAPES = {"tcn": (5, 3), "up": (7,), "decoder": (4,)}


def _steps(kind, momentum, frozen=(), clip=1.0, steps=3):
    """Both sides over ``steps`` steps of drawn gradients; returns the
    port's parameters, optax's, the port's norms and the initial ones."""
    cfg = dict(kind=kind, lr=1e-2, momentum=momentum, grad_clip_norm=clip)
    rng = np.random.default_rng(4)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    tx = jax_optim.make_optimizer(JaxOptimConfig(**cfg),
                                  frozen_subtrees=tuple(frozen))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = optim.make_optimizer(OptimConfig(**cfg), tparams.values())
    norms = []
    for _ in range(steps):
        grads = {k: (3.0 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        norms.append((optim.apply_gradients(
            opt, clip, [tparams[k] for k in frozen]), grads))
    return tparams, jparams, norms, params


@pytest.mark.parametrize("kind,momentum", [("adam", 0.9), ("sgd", 0.9),
                                           ("sgd", 0.0)])
def test_adam_and_sgd_match_optax(kind, momentum):
    tparams, jparams, _, _ = _steps(kind, momentum)
    assert isinstance(optim.make_optimizer(
        OptimConfig(kind=kind), tparams.values()),
        {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}[kind])
    for k in SHAPES:
        _close(tparams[k].detach(), jparams[k], OPT_TOL, k)


@pytest.mark.parametrize("kind", ["adamw", "adam", "sgd"])
def test_frozen_params_stay_and_leave_the_clip_norm(kind):
    frozen = ("up",)
    tparams, jparams, norms, init = _steps(kind, 0.9, frozen=frozen)
    if kind != "adamw":
        assert torch.equal(tparams["up"].detach(),
                           torch.from_numpy(init["up"]))
    for norm, grads in norms:
        want = np.sqrt(sum((grads[k].astype(np.float64) ** 2).sum()
                           for k in SHAPES if k not in frozen))
        _close(norm, want, OPT_TOL, "clip norm without the frozen leaves")
    for k in SHAPES:
        _close(tparams[k].detach(), jparams[k], OPT_TOL, k)


def test_create_train_state_freezes_top_level_modules():
    cfg = ModelConfig(**SMALL)
    state = create_train_state(cfg, device="cpu", frozen_params=("tcn",))
    names = {id(p) for n, p in state.model.named_parameters()
             if n.startswith("tcn.")}
    assert {id(p) for p in state.frozen} == names and names
    with pytest.raises(ValueError, match="top-level"):
        create_train_state(cfg, device="cpu", frozen_params=("nope",))


# ---------------------------------------------------------------------------
# train_pose_model: resume, monitor, data dtype
# ---------------------------------------------------------------------------

CFG = ModelConfig(**SMALL, dropout=0.3, conv_dropout=0.2)


def _splits(seed=1):
    rng = np.random.default_rng(seed)

    def split(n):
        x = rng.standard_normal((n, CFG.num_subcarriers,
                                 CFG.window_size)).astype(np.float32)
        y = 0.3 * np.tanh(x.mean(axis=2)[:, :30]).reshape(n, 15, 2)
        return x, y.astype(np.float32)
    return [split(n) for n in (48, 16, 16)]


def _run(out, epochs, **kw):
    run = Config(model=CFG, train=TrainConfig(
        batch_size=8, num_epochs=epochs, use_augmentation=True,
        optim=OptimConfig(lr=1e-3), **kw.pop("train", {})))
    return loop.train_pose_model(*_splits(), run, str(out), device="cpu",
                                 verbose=False, **kw)


def test_stopped_and_resumed_run_equals_the_uninterrupted_run(tmp_path):
    straight = _run(tmp_path / "straight", 3)
    _run(tmp_path / "resumed", 2)
    resumed = _run(tmp_path / "resumed", 3)
    assert resumed.history == straight.history
    assert all(len(v) == 3 for v in straight.history.values())
    assert resumed.test_metrics == straight.test_metrics
    assert resumed.best_epoch == straight.best_epoch
    np.testing.assert_array_equal(resumed.predictions, straight.predictions)
    for k, v in straight.state_dict.items():
        assert torch.equal(resumed.state_dict[k], v), k
    a = load_checkpoint(str(tmp_path / "straight" / "latest_checkpoint.pkl"))
    b = load_checkpoint(str(tmp_path / "resumed" / "latest_checkpoint.pkl"))
    assert a["epoch"] == b["epoch"] == 2
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    for name in ("best_pose_model.pth", "best_pose_model.msgpack"):
        with open(tmp_path / "straight" / name, "rb") as f, \
                open(tmp_path / "resumed" / name, "rb") as g:
            assert f.read() == g.read(), name
    # a run that resumes from a finished bundle trains nothing more
    again = _run(tmp_path / "resumed", 3)
    assert again.history == straight.history and again.timings["train_s"] == []


def test_monitor_pck_keeps_the_largest_val_pck(tmp_path):
    res = _run(tmp_path, 3, monitor="pck")
    pck = res.history["val_pck"]
    assert res.best_epoch == int(np.argmax(pck))
    ckpt = load_checkpoint(str(tmp_path / "latest_checkpoint.pkl"))
    assert ckpt["early_stopping"]["mode"] == "max"
    assert ckpt["scheduler"]["mode"] == "max"
    assert ckpt["early_stopping"]["best"] == max(pck)
    with pytest.raises(ValueError, match="monitor"):
        _run(tmp_path / "x", 1, monitor="loss")


def test_data_dtype_bfloat16_stages_bf16_csi(tmp_path):
    x, y = _splits()[0]
    sx, sy = loop._stage((x, y), torch.device("cpu"), torch.bfloat16)
    assert sx.dtype == torch.bfloat16 and sy.dtype == torch.float32
    assert torch.equal(sx, torch.from_numpy(x).to(torch.bfloat16))
    res = _run(tmp_path, 1, train=dict(data_dtype="bfloat16"))
    assert all(np.isfinite(v) for v in res.test_metrics.values())


def test_in_memory_run_writes_nothing(tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run = Config(model=CFG, train=TrainConfig(batch_size=8, num_epochs=1))
        loop.train_pose_model(*_splits(), run, device="cpu", verbose=False)
    finally:
        os.chdir(cwd)
    assert os.listdir(tmp_path) == []
