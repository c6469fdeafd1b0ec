"""The port's MM-Fi trainer == the JAX package's, on the CPU.

* The fused train path of ``WiFlowMMFiModel`` (``tcn_train_impl =
  conv_train_impl = "fused"``) against the JAX fused MM-Fi model at
  ``tests/test_torch_mmfi.py``'s small config (the JAX side through its
  Pallas stage kernels in interpret mode; batch 8, where its gates
  engage), dropout 0, fp32: the train-mode output and the updated running
  statistics within 2e-4 (``TOL``), every gradient within 1e-3.
* Within the port: one train step through the fused path against the
  same step through stock ops, dropout on, one seed, at the small config
  and at full width (batch 2, fp32), with the tolerances and floors of
  ``tests/test_torch_fused_train.py``.
* ``train_pose_model`` with the MM-Fi CLI's hooks (the MM-Fi skeleton,
  root-relative PCK, root-aligned MPJPE, ``monitor="pck"``, weight decay
  1e-4) on a synthetic MM-Fi tree: the early stop and the plateau run in
  mode max on val PCK, the best epoch is the one with the largest, and its ``.msgpack`` read by the JAX loader gives the
  port module's forward through the flax model (``TOL``) and the ``.pth``'s
  tensors exactly.
* ``ops/kernels/stage_fused.py::step_launches`` describes both models'
  fused steps: 39 stages and 9 joins for ``ModelConfig``, 34 and 8 for
  ``MMFiModelConfig``, each launch as the model makes it (recorded on the
  CPU).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.core import checkpoint as jax_checkpoint
from wiflow_tpu.models.torch_compat import (
    to_torch_state_dict, wiflow_mmfi_spec as jax_mmfi_spec,
)
from wiflow_tpu.models.wiflow import fused_conv_gate
from wiflow_tpu.models.wiflow_mmfi import WiFlowMMFiModel as JaxMMFiModel

from tests.test_torch_fused_train import FUSED, GRAD_TOL, _close, _close_leaves
from tests.test_torch_harness import TOL, nontrivial_stats
from tests.test_torch_mmfi import SMALL, SmallJaxConfig, _port_config
from wiflow_tpu_torch.core.config import (
    MMFI_SKELETON_CONNECTIONS, Config, ModelConfig, OptimConfig, TrainConfig,
)
from wiflow_tpu_torch.core.checkpoint import load_best_model, load_checkpoint
from wiflow_tpu_torch.data.mmfi import (
    generate_synthetic_mmfi, make_dataset, split_val_test,
)
from wiflow_tpu_torch.metrics.mmfi_metrics import (
    root_aligned_mpjpe, root_relative_pck_fractions,
)
from wiflow_tpu_torch.models import wiflow
from wiflow_tpu_torch.models.torch_compat import (
    load_state_dict, state_dict_from_jax,
)
from wiflow_tpu_torch.models.wiflow_mmfi import (
    MMFiModelConfig, WiFlowMMFiModel,
)
from wiflow_tpu_torch.ops.kernels import stage_fused as sk
from wiflow_tpu_torch.train.loop import train_pose_model
from wiflow_tpu_torch.train.steps import (
    create_train_state, make_hooks, train_step,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pool in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_antennas, cfg.num_subcarriers,
         cfg.window_size)).astype(np.float32)


def test_fused_model_matches_jax_fused_model():
    batch = 8
    jcfg = dataclasses.replace(SmallJaxConfig(**SMALL), dropout=0.0,
                               conv_dropout=0.0, **FUSED)
    # the JAX gates engage at this batch (they need a multiple of 8)
    assert fused_conv_gate(
        train=True, impl=jcfg.conv_train_impl,
        conv_channels=jcfg.conv_channels, w0=jcfg.tcn_proj_channels,
        r_rows=batch * jcfg.window_size) is not None
    model = JaxMMFiModel(jcfg)
    x = _inputs(jcfg, batch, 3)
    gv = np.random.default_rng(4).standard_normal(
        (batch, 17, 3)).astype(np.float32)
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

    cfg = _port_config(jcfg)
    assert cfg.tcn_train_impl == cfg.conv_train_impl == "fused"
    port = load_state_dict(WiFlowMMFiModel(cfg, device="cpu"),
                           state_dict_from_jax(v, cfg))
    port.train()
    assert port.tcn.network[0].fused and port.up.fused
    assert all(blk.fused for blk in port.residual_blocks)
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
    model = WiFlowMMFiModel(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    model.dropout_generator.manual_seed(seed)
    state = create_train_state(optim=OptimConfig(weight_decay=1e-4),
                               model=model)
    m = train_step(state, x, y, hooks=make_hooks(
        connections=MMFI_SKELETON_CONNECTIONS,
        pck_fn=root_relative_pck_fractions, mpe_fn=root_aligned_mpjpe))
    return (m, {n: p.grad for n, p in model.named_parameters()},
            {n: b for n, b in model.named_buffers() if "running" in n},
            model)


@pytest.mark.parametrize("kw", [
    pytest.param({**{k: v for k, v in SMALL.items()
                     if k != "attention_module_impl"},
                  "tcn_channels": (36, 24)}, id="small"),
    pytest.param(dict(compute_dtype="float32"), id="full-width"),
])
def test_fused_step_equals_stock_step_with_dropout_on(kw):
    cfg = MMFiModelConfig(**kw)
    assert cfg.dropout > 0 and cfg.conv_dropout > 0
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_inputs(cfg, 2, 6))
    y = torch.from_numpy((0.3 * np.tanh(rng.standard_normal(
        (2, 17, 3)))).astype(np.float32))
    ms, gs, bs, stock = _one_step(cfg, x, y)
    mf, gf, bf, fused = _one_step(MMFiModelConfig(**kw, **FUSED), x, y)
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
    m2 = _one_step(MMFiModelConfig(**kw, **FUSED), x, y, seed=8)[0]
    assert abs(float(m2["loss"]) - float(mf["loss"])) > 1e-6


# A narrow MM-Fi model that reads the full [3, 114, 10] frames of a tree.
NARROW = dict(tcn_channels=(36, 24), tcn_groups=6, conv_channels=(4, 8, 16,
                                                                  32),
              attention_groups=4, compute_dtype="float32")


def test_train_pose_model_with_the_mmfi_hooks(tmp_path):
    root = str(tmp_path / "mmfi")
    generate_synthetic_mmfi(root, subjects=("S01", "S02", "S11"),
                            actions=("A01", "A02"), frames=24, seed=1,
                            fmt="npy", learnable=True)
    train_ds, val_ds = make_dataset(root, {
        "modality": "wifi-csi", "protocol": "protocol3",
        "split_to_use": "random_split",
        "random_split": {"ratio": 0.7, "random_seed": 0}})
    train_xy = train_ds.materialize()
    val_all = val_ds.materialize()
    vi, ti = split_val_test(len(val_ds))
    cfg = Config(train=TrainConfig(
        batch_size=16, num_epochs=3, seed=3,
        optim=OptimConfig(lr=1e-3, weight_decay=1e-4)))
    model = WiFlowMMFiModel(MMFiModelConfig(**NARROW), device="cpu",
                            generator=torch.Generator().manual_seed(3))
    out = str(tmp_path / "out")
    result = train_pose_model(
        train_xy, (val_all[0][vi], val_all[1][vi]),
        (val_all[0][ti], val_all[1][ti]), cfg, out, model=model,
        connections=MMFI_SKELETON_CONNECTIONS,
        pck_fn=root_relative_pck_fractions, mpe_fn=root_aligned_mpjpe,
        monitor="pck", verbose=False)
    pck = result.history["val_pck"]
    assert len(pck) == 3
    assert result.best_epoch == int(np.argmax(pck))
    assert result.predictions.shape[1:] == (17, 3)
    # the early stop and the plateau follow the largest val PCK
    bundle = load_checkpoint(f"{out}/latest_checkpoint.pkl")
    assert bundle["early_stopping"]["mode"] == "max"
    assert bundle["early_stopping"]["best"] == max(pck)
    assert bundle["early_stopping"]["best"] != min(
        result.history["val_mpe"])
    assert bundle["scheduler"]["mode"] == "max"
    assert bundle["optimizer"]["param_groups"][0]["weight_decay"] == 1e-4

    # the best weights, through the JAX loader and the flax model
    pth = load_best_model(f"{out}/best_pose_model.pth")
    for k, t in result.state_dict.items():
        assert torch.equal(pth[k], t), k
    restored = jax_checkpoint.load_best_model(f"{out}/best_pose_model.msgpack")
    jcfg = SmallJaxConfig(num_subcarriers=114, tcn_groups=6,
                          attention_groups=4, compute_dtype="float32",
                          attention_module_impl="xla")
    assert _port_config(jcfg) == MMFiModelConfig(**NARROW)
    ref_sd = to_torch_state_dict(restored, spec=jax_mmfi_spec(jcfg))
    assert sorted(ref_sd) == sorted(k for k in pth
                                    if not k.endswith("num_batches_tracked"))
    for k, a in ref_sd.items():
        np.testing.assert_array_equal(pth[k].numpy(), a, err_msg=k)
    x = val_all[0][ti][:5]
    ref = np.asarray(JaxMMFiModel(jcfg).apply(restored, jnp.asarray(x),
                                              train=False))
    port = load_state_dict(WiFlowMMFiModel(MMFiModelConfig(**NARROW),
                                           device="cpu"), pth)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def _recorded_launches(model, x):
    """The ``stage`` and ``join`` calls of one train-mode forward of
    ``model``, described as ``step_launches`` describes them."""
    stages, joins = [], []
    stage, join = wiflow.stage, wiflow.join

    def mask_kind(mask, x):
        return None if mask is None else (
            "element" if mask.shape == x.shape else "sample")

    def rec_stage(x, m, a, b, mask, weight, bias, *, kind, dil=1, **kw):
        g = sk.stage_geometry(kind, tuple(x.shape[:-1]), x.shape[-1],
                              weight.shape[0],
                              x.shape[-1] // weight.shape[1], dil)
        stages.append(dict(kind=kind, lead=tuple(x.shape[:-1]),
                           ci=x.shape[-1], co=weight.shape[0],
                           groups=g.groups, dil=g.dil, pro=a is not None,
                           mask=mask_kind(mask, x), bias=bias is not None,
                           need_gx=x.requires_grad))
        return stage(x, m, a, b, mask, weight, bias, kind=kind, dil=dil,
                     **kw)

    def rec_join(h, m_h, a_h, b_h, mask, res, m_r=None, a_r=None, b_r=None,
                 **kw):
        joins.append(dict(lead=tuple(h.shape[:-1]), c=h.shape[-1],
                          mask=mask_kind(mask, h), res_norm=a_r is not None,
                          act_h=kw.get("act_h", True)))
        return join(h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r, **kw)

    wiflow.stage, wiflow.join = rec_stage, rec_join
    try:
        model.train()(x)
    finally:
        wiflow.stage, wiflow.join = stage, join
    return stages, joins


@pytest.mark.parametrize("name", ["flagship", "mmfi"])
def test_step_launches_describe_the_fused_step(name):
    batch = 2
    if name == "mmfi":
        cfg = MMFiModelConfig(compute_dtype="float32", **FUSED)
        model = WiFlowMMFiModel(cfg, device="cpu")
        x = torch.zeros(batch, 3, 114, 10)
        counts, t = (34, 8), 10
    else:
        cfg = ModelConfig(compute_dtype="float32", **FUSED)
        model = wiflow.WiFlowPoseModel(cfg, device="cpu")
        x = torch.zeros(batch, 540, 20)
        counts, t = (39, 9), 20
    stages, joins = sk.step_launches(cfg, batch)
    assert (len(stages), len(joins)) == counts
    assert (stages, joins) == _recorded_launches(model, x)
    assert all(s["lead"][:2] == (batch, t) for s in stages)
    if name == "mmfi":
        # the TCN at 342 -> 342 -> 306 -> 288 channels in 18 groups of 19,
        # 17 and 16; the conv stack from the projection's 272 positions
        # down to 17
        tcn = [s for s in stages if s["kind"] == "causal3"]
        assert {(s["ci"], s["groups"], s["dil"]) for s in tcn} == {
            (342, 18, 1), (342, 18, 2), (306, 18, 2), (306, 18, 4),
            (288, 18, 4)}
        assert [j["c"] for j in joins[:3]] == [342, 306, 288]
        assert [s["lead"][2] for s in stages if s["kind"] in (
            "identity", "chunk1") and len(s["lead"]) == 3] == [
                272, 272, 136, 68, 34]
        assert joins[-1]["lead"] == (batch, t, 17) and joins[-1]["c"] == 64
        # mmfi_stage_cases' samples share those geometries
        widths = {s["lead"][-1] for s in stages}
        for c in sk.mmfi_stage_cases(batch):
            assert c["lead"][1] == t
            assert len(c["lead"]) == 2 or c["lead"][2] in widths
    assert not stages[0]["need_gx"]             # the model's own input
    assert all(s["need_gx"] for s in stages if len(s["lead"]) == 3)
