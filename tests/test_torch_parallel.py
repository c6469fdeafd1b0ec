"""The port's data-parallel training == one process on the global batch.

Two gloo ranks (``parallel/mesh.py::spawn``: new processes, a ``file://``
store) run, once for the module, what the tests then hold against the
same work in this process without a process group, mirroring the JAX
package's ``tests/test_parallel.py``:

* 3 steps (clip 1.0) on 3 global batches of 8 from the same seeded
  weights, for the flagship's stock-op path, the flagship with both fused
  switches (``stage`` / ``join``'s plain versions on the CPU), the
  flagship with dropout on (each rank keeps its rows of the global
  batch's mask), the MM-Fi model and HPE-Li, fp32: the loss trajectory,
  the running statistics and the parameters at 1e-5 of the largest entry
  of their kind (some leaves are 0 in exact arithmetic and rounding noise
  as computed: a conv bias before a BatchNorm, the batch mean of a
  BatchNorm'd input; and BatchNorm's ``E[x^2] - mean^2``, the JAX
  formula, cancels where a channel's mean outweighs its spread), and the
  two ranks' parameters bit for bit;
* one AdamW step of the flagship from a JAX model's weights, held to the
  JAX package's step on its 8-device mesh (``tests/conftest.py``) at the
  tolerances of ``tests/test_torch_train_step.py``: the metrics, the
  running statistics and every gradient leaf (the ranks' clipped mean
  gradient against the one the JAX step's Adam state holds, its first
  moment ``(1 - b1) g``; the worst leaf read 1.7e-4 of its scale on a
  CPU);
* ``train_pose_model`` for 2 epochs (augmentation and dropout on) at
  ``MeshConfig(num_devices=2)`` against ``num_devices=1``: the history,
  the test metrics and the test predictions;
* a rank's BatchNorm outside the trainer's steps, in the process group,
  reduces nothing: its moments are its own rows'.

The 3 steps are SGD with momentum 0.9, as in the JAX package's test,
for its reason: AdamW's first step moves every parameter by about ``lr``
whatever the size of its gradient, so where a gradient is rounding noise
(0 in exact arithmetic) the two runs, which sum in another order, step
apart by ``2 lr``; measured on a CPU, that takes the MM-Fi model's
third loss 1.4e-4 apart.  The trainer's epochs run SGD too; AdamW is
held where the reference holds it, in the step against the JAX mesh
(``2 lr`` on the parameters, the gradients at ``GRAD_TOL``).

The workers import no JAX; the file pins one intra-op thread a process.
"""

import os

import numpy as np
import pytest
import torch

from wiflow_tpu_torch.core.config import (
    MMFI_SKELETON_CONNECTIONS, Config, LossConfig, MeshConfig, ModelConfig,
    OptimConfig, TrainConfig,
)
from wiflow_tpu_torch.metrics.mmfi_metrics import (
    root_aligned_mpjpe, root_relative_pck_fractions,
)
from wiflow_tpu_torch.models.baselines import HPELiNet
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.models.wiflow_mmfi import (
    MMFiModelConfig, WiFlowMMFiModel,
)
from wiflow_tpu_torch.parallel import mesh
from wiflow_tpu_torch.train.loop import train_pose_model
from wiflow_tpu_torch.train.optim import make_optimizer
from wiflow_tpu_torch.train.steps import TrainState, make_hooks, train_step

WORLD, BATCH, STEPS = 2, 8, 3
TOL = 1e-5
LR = OptimConfig().lr
SGD = OptimConfig(lr=1e-2, kind="sgd", momentum=0.9)
# tests/test_torch_harness.py's SMALL (not imported: it loads JAX, and
# the ranks import this module)
SMALL = dict(num_subcarriers=40, tcn_channels=(40, 240), tcn_groups=4,
             conv_channels=(4, 8, 16, 32), attention_groups=4,
             compute_dtype="float32")
NO_DROPOUT = dict(dropout=0.0, conv_dropout=0.0)
CASES = {
    "flagship": ("flagship", ModelConfig(**SMALL, **NO_DROPOUT)),
    "flagship_fused": ("flagship", ModelConfig(
        **SMALL, **NO_DROPOUT, tcn_train_impl="fused",
        conv_train_impl="fused")),
    "flagship_dropout": ("flagship", ModelConfig(**SMALL)),
    "mmfi": ("mmfi", MMFiModelConfig(compute_dtype="float32", **NO_DROPOUT)),
    "hpeli": ("hpeli", None),
}
SHAPES = {"flagship": ((40, 20), (15, 2)), "mmfi": ((3, 114, 10), (17, 3)),
          "hpeli": ((540, 20), (15, 2))}


def _data(kind, n=BATCH * STEPS, seed=0):
    xs, ys = SHAPES[kind]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *xs)).astype(np.float32)
    y = 0.3 * np.tanh(x.reshape(n, -1)[:, :int(np.prod(ys))])
    return torch.from_numpy(x), torch.from_numpy(y.reshape(n, *ys))


def _model(case):
    kind, cfg = CASES[case]
    gen = torch.Generator().manual_seed(0)
    if kind == "flagship":
        model = WiFlowPoseModel(cfg, device="cpu", generator=gen)
        model.dropout_generator.manual_seed(1)
        return model, make_hooks()
    if kind == "mmfi":
        return (WiFlowMMFiModel(cfg, device="cpu", generator=gen),
                make_hooks(LossConfig(), MMFI_SKELETON_CONNECTIONS,
                           root_relative_pck_fractions, root_aligned_mpjpe))
    return HPELiNet(compute_dtype="float32", device="cpu",
                    generator=gen), make_hooks()


def _steps(case, init=None, steps=STEPS, optim=SGD):
    """``steps`` steps of ``case`` on its global batches: each step's
    metrics (averaged over the ranks) and the state_dict after them."""
    model, hooks = _model(case)
    if init is not None:
        model.load_state_dict(init, strict=False)
    model.train()
    state = TrainState(model, make_optimizer(optim, model.parameters()), 1.0)
    x, y = _data(CASES[case][0])
    ms = [mesh.mean_over_ranks(train_step(
        state, x[s * BATCH:(s + 1) * BATCH], y[s * BATCH:(s + 1) * BATCH],
        hooks=hooks)) for s in range(steps)]
    return {"metrics": ms, "params": {n for n, _ in model.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _epochs(num_devices):
    """2 epochs of ``train_pose_model`` on small flagship splits, dropout
    and augmentation on, no files."""
    x, y = _data("flagship", 64, seed=5)
    cfg = Config(model=ModelConfig(**SMALL),
                 train=TrainConfig(batch_size=BATCH, num_epochs=2, seed=3,
                                   use_augmentation=True, optim=SGD),
                 mesh=MeshConfig(num_devices=num_devices))
    r = train_pose_model((x[:40], y[:40]), (x[40:52], y[40:52]),
                         (x[52:], y[52:]), cfg, device="cpu", verbose=False)
    return {"history": r.history, "test": r.test_metrics,
            "predictions": r.predictions}


def _bn_outside_step():
    """A train-mode BatchNorm's batch mean on this rank's own rows, run
    in the process group but outside ``train_step``."""
    from wiflow_tpu_torch.ops.norm import batch_norm_train
    x = torch.arange(8.0).reshape(4, 2) + 100.0 * mesh.rank()
    _, mean, _ = batch_norm_train(x, torch.ones(2), torch.zeros(2),
                                  torch.zeros(2), torch.ones(2))
    return mean / 0.1


def _rank_work(out):
    """What each rank runs: every case's steps, the step from the JAX
    weights, the epochs; rank r saves ``rank{r}.pt``."""
    torch.set_num_threads(1)
    res = {case: _steps(case) for case in CASES}
    res["jax"] = _steps("flagship", torch.load(os.path.join(out, "jax.pt")),
                        steps=1, optim=OptimConfig())
    res["epochs"] = _epochs(WORLD)
    res["outside_step"] = _bn_outside_step()
    torch.save(res, os.path.join(out, f"rank{mesh.rank()}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, and the JAX variables of the 8-device
    comparison, whose weights the ranks start from."""
    import jax
    from wiflow_tpu.core.config import ModelConfig as JaxModelConfig

    from tests.test_torch_harness import jax_model, port_config
    from wiflow_tpu_torch.models.torch_compat import state_dict_from_jax

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("ranks"))
    jcfg = JaxModelConfig(**SMALL, **NO_DROPOUT)
    jmodel, v = jax_model(jcfg, seed=4)
    torch.save(state_dict_from_jax(v, port_config(jcfg)),
               os.path.join(out, "jax.pt"))
    mesh.spawn(_rank_work, WORLD, "cpu", out)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    yield ranks, (jax, jcfg, jmodel, v), out
    torch.set_num_threads(threads)


def _close(got, ref, tol, what, floor=0.0):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    scale = max(ref.abs().max().item(), floor, 1e-30)
    err = (got - ref).abs().max().item()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_equal_one_process(runs, case):
    ranks, _, _ = runs
    ref = _steps(case)
    got = ranks[0][case]
    for s, (m, r) in enumerate(zip(got["metrics"], ref["metrics"])):
        _close(m["loss"], r["loss"], TOL, f"step {s} loss")
    sd = ref["state"]
    for group in (ref["params"], [k for k in sd if "running" in k]):
        floor = max(sd[k].abs().max().item() for k in group)
        for k in group:
            _close(got["state"][k], sd[k], TOL, k, floor)
    assert all(torch.equal(got["state"][k], v) for k, v in sd.items()
               if k.endswith("num_batches_tracked"))
    other = ranks[1][case]["state"]
    assert all(torch.equal(other[k], v) for k, v in got["state"].items())


def test_ranks_match_jax_eight_device_mesh(runs):
    ranks, (jax, jcfg, jmodel, v), _ = runs
    import jax.numpy as jnp
    from wiflow_tpu.core.config import LossConfig as JaxLossConfig
    from wiflow_tpu.core.config import OptimConfig as JaxOptimConfig
    from wiflow_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from wiflow_tpu.train.optim import make_optimizer as jax_make_optimizer
    from wiflow_tpu.train.steps import TrainState as JaxTrainState
    from wiflow_tpu.train.steps import make_step_fns

    from tests.test_torch_harness import TOL as PARITY_TOL
    from tests.test_torch_harness import port_config
    from tests.test_torch_train_step import GRAD_TOL
    from wiflow_tpu_torch.models.torch_compat import state_dict_from_jax

    x, y = _data("flagship")
    x, y = x[:BATCH].numpy(), y[:BATCH].numpy()
    jmesh = make_mesh(8)
    tx = jax_make_optimizer(JaxOptimConfig())
    state = JaxTrainState(*replicate(jmesh, (
        v["params"], v["batch_stats"], tx.init(v["params"]))))
    train_epoch, _ = make_step_fns(jmodel, tx, JaxLossConfig(), mesh=jmesh,
                                   scan=False)
    new, metrics = train_epoch(state, shard_batch(jmesh, jnp.asarray(x)),
                               shard_batch(jmesh, jnp.asarray(y)),
                               jnp.arange(BATCH)[None], jax.random.key(0),
                               False)
    new, metrics = jax.device_get((new, metrics))
    got = ranks[0]["jax"]
    import optax
    adam = [st for st in jax.tree.leaves(
        new.opt_state, is_leaf=lambda st: isinstance(st, optax.ScaleByAdamState))
        if isinstance(st, optax.ScaleByAdamState)]
    assert len(adam) == 1
    b1 = JaxOptimConfig().betas[0]
    ref_grads = state_dict_from_jax(
        {"params": jax.tree.map(lambda mu: np.asarray(mu) / (1 - b1),
                                adam[0].mu),
         "batch_stats": v["batch_stats"]}, port_config(jcfg))
    floor = 1e-2 * max(ref_grads[n].abs().max().item()
                       for n in got["params"])
    for n in got["params"]:
        _close(got["grads"][n], ref_grads[n], GRAD_TOL, f"grad {n}", floor)
    for k in ("loss", "mpe", "pck", "grad_norm"):
        _close(got["metrics"][0][k], torch.as_tensor(np.array(metrics[k])),
               PARITY_TOL, k)
    after = state_dict_from_jax({"params": new.params,
                                 "batch_stats": new.batch_stats},
                                port_config(jcfg))
    stats = [k for k in after if "running" in k]
    floor = 1e-3 * max(after[k].abs().max().item() for k in stats)
    for k in stats:
        err = (got["state"][k] - after[k]).abs().max().item()
        assert err <= PARITY_TOL * max(after[k].abs().max().item(), floor), k
    for k in got["params"]:
        err = (got["state"][k] - after[k]).abs().max().item()
        assert err <= 2 * LR + 1e-6, (k, err)


def test_train_pose_model_two_ranks_equal_one(runs):
    ranks, _, _ = runs
    ref = _epochs(1)
    got = ranks[0]["epochs"]
    assert set(got["history"]) == set(ref["history"])
    for k, r in ref["history"].items():
        _close(got["history"][k], r, TOL, k)
    for k, r in ref["test"].items():
        _close(got["test"][k], r, TOL, k)
    _close(got["predictions"], ref["predictions"], TOL, "predictions")
    assert ranks[1]["epochs"]["history"] == got["history"]


def test_bn_outside_the_steps_stays_local(runs):
    """In the group but outside ``train_step``, each rank's BatchNorm
    takes its own rows' moments: the ranks' means differ by the 100 the
    data differ by."""
    ranks, _, _ = runs
    own = [r["outside_step"] for r in ranks]
    assert torch.allclose(own[1] - own[0], torch.full((2,), 100.0))


def test_default_mesh_runs_one_process(monkeypatch, capsys):
    """``MeshConfig()`` (every device) outside a process group, on a host
    that shows 2 CUDA devices: the trainer runs as this one process, as
    the CLIs that train one model a device count of 1 need; the CLIs that
    take every device start the ranks themselves."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.mesh_world(None, torch.device("cuda")) == 1
    assert mesh.resolve_world(None, "cuda") == 2
    x, y = _data("flagship", 24, seed=7)
    cfg = Config(model=ModelConfig(**SMALL, **NO_DROPOUT),
                 train=TrainConfig(batch_size=BATCH, num_epochs=1, seed=3,
                                   optim=SGD))
    assert cfg.mesh == MeshConfig()
    r = train_pose_model((x[:16], y[:16]), (x[16:20], y[16:20]),
                         (x[20:], y[20:]), cfg, device="cpu")
    assert "1 rank(s)" in capsys.readouterr().out
    assert np.isfinite(r.history["train_loss"]).all()


def test_more_cuda_ranks_than_devices_raise():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="more ranks than devices"):
        mesh.resolve_world(have + 1 if have else 2, "cuda")
    from wiflow_tpu_torch.cli import run
    with pytest.raises(ValueError, match="more ranks than devices"):
        run.main(["--gpu", str(max(have + 1, 2)), "--epochs", "1"])


def test_cli_trains_on_two_ranks(tmp_path, capfd, monkeypatch):
    """``cli.run --gpu 2 --device cpu``: two gloo ranks, started by the
    command; rank 0 alone prints and writes the artifacts."""
    from wiflow_tpu_torch.cli import run
    from wiflow_tpu_torch.data.synthetic import make_preprocessed_dataset

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data_dir = make_preprocessed_dataset(str(tmp_path), num_files=8,
                                         frames_per_file=40)
    out = str(tmp_path / "out")
    assert run.main(["--gpu", "2", "--device", "cpu", "--compute_dtype",
                     "float32", "--epochs", "1", "--batch_size", "16",
                     "--no_videos", "--data_dir", data_dir,
                     "--output_dir", out]) == 0
    text = capfd.readouterr().out
    assert text.count("[train] ") == 1 and "2 rank(s)" in text
    assert text.count("Epoch 1/1") == 1
    for name in ("training_history.csv", "test_predictions.csv",
                 "best_pose_model.pth", "latest_checkpoint.pkl"):
        assert os.path.exists(os.path.join(out, name)), name


def test_several_ranks_need_a_process_group():
    assert mesh.resolve_world(None, "cpu") == 1
    assert mesh.resolve_world(3, "cpu") == 3
    with pytest.raises(ValueError, match="no process group"):
        mesh.mesh_world(2, "cpu")
    assert mesh.mesh_world(1, "cpu") == 1
    x = torch.arange(6)
    assert mesh.local_rows(x) is x and mesh.pad_to_multiple(7, 4) == 8
