"""The ablation switches of the port == the JAX package's, on the CPU.

The five variants of ``cli/ablation_demo.py`` (``tcn_conv`` ``grouped``,
``plain``, ``depthwise``; ``encoder_kind="conv2d"``;
``use_attention=False``) at a small config (a 2-level narrow TCN), each
against the JAX package's ``WiFlowPoseModel`` with its weights carried
across by ``models/torch_compat.py``:

* the parameter counts, and the weights' round trip through
  ``state_dict_from_jax`` / ``jax_variables_from_state_dict`` bit for bit;
* the eval output and the train-mode output (dropout 0) within ``TOL``
  (2e-4) x max|ref|, the running statistics within ``TOL``, every
  gradient within 1e-3 (floored at 1e-2 of the largest gradient);
* the best-weights files: ``.pth`` only where ``encoder_kind="wiflow"``,
  ``.msgpack`` always, and the ``.msgpack`` reads back.

For ``plain`` and ``depthwise`` under ``tcn_train_impl="fused"``: the
port's fused model (``stage_plain`` / ``join_plain``) against the JAX
fused model (its Pallas stages in interpret mode; batch 8, which its gate
needs), and against the port's own stock-op step with dropout on.
``stage_plan`` plans both new TCN geometries (one group; a group a channel)
at 540/440/340/240 channels, batch 256, 64 and 7, in bf16 and fp32.
``pack_fast`` refuses every variant but the default.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models.wiflow import WiFlowPoseModel as JaxModel

from tests.test_torch_harness import SMALL, TOL, nontrivial_stats, port_config
from wiflow_tpu_torch.core import checkpoint
from wiflow_tpu_torch.core.config import ModelConfig, OptimConfig
from wiflow_tpu_torch.models.fast import pack_fast
from wiflow_tpu_torch.models.torch_compat import (
    jax_variables_from_state_dict, load_state_dict, state_dict_from_jax,
)
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.ops.kernels.stage_fused import (
    stage_geometry, stage_plan, step_launches,
)
from wiflow_tpu_torch.train.steps import create_train_state, train_step

GRAD_TOL = 1e-3
VARIANTS = {
    "full": {},
    "tcn_plain": {"tcn_conv": "plain"},
    "conv2d_encoder": {"encoder_kind": "conv2d"},
    "group_depthwise": {"tcn_conv": "depthwise"},
    "no_attention": {"use_attention": False},
}
FUSED_TCN = dict(tcn_train_impl="fused")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol, what, floor=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), floor, 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _jax_variables(jcfg, x):
    model = JaxModel(jcfg)
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(0)}, jnp.asarray(x))
    return model, nontrivial_stats(jax.tree.map(np.asarray, v))


def _hold_to_jax(jcfg, batch=8):
    """Eval, train output, running statistics and gradients of the port's
    ``WiFlowPoseModel`` against the JAX one at ``jcfg`` (dropout 0)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((batch, jcfg.num_subcarriers,
                             jcfg.window_size)).astype(np.float32)
    gv = rng.standard_normal((batch, 15, 2)).astype(np.float32)
    model, v = _jax_variables(jcfg, x)
    cfg = port_config(jcfg)
    port = load_state_dict(WiFlowPoseModel(cfg, device="cpu"),
                           state_dict_from_jax(v, cfg))
    assert sum(p.numel() for p in port.parameters()) == sum(
        np.size(p) for p in jax.tree.leaves(v["params"]))

    ref = model.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), ref, TOL, "eval output")

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
    port.train()
    y = port(torch.from_numpy(x))
    (y * torch.from_numpy(gv)).sum().backward()
    _close(y.detach(), ref_y, TOL, "train output")
    after = state_dict_from_jax(
        {"params": v["params"],
         "batch_stats": jax.tree.map(np.asarray, ref_st["batch_stats"])}, cfg)
    stats = [k for k in after if "running" in k]
    floor = 1e-3 * max(float(after[k].abs().max()) for k in stats)
    got = port.state_dict()
    for k in stats:
        _close(got[k], after[k], TOL, k, floor)
    ref_sd = state_dict_from_jax({"params": jax.tree.map(np.asarray,
                                                         ref_grads),
                                  "batch_stats": v["batch_stats"]}, cfg)
    # bn_similarity.bias cancels in the softmax: no gradient on either side
    grads = {n: p.grad for n, p in port.named_parameters()
             if p.grad is not None}
    assert len(grads) == len(list(port.parameters())) - (
        2 if cfg.use_attention else 0)
    floor = 1e-2 * max(float(ref_sd[n].abs().max()) for n in grads)
    for n, g in grads.items():
        _close(g, ref_sd[n], GRAD_TOL, f"grad {n}", floor)
    return v, cfg


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax(name):
    jcfg = JaxModelConfig(**SMALL, **VARIANTS[name], dropout=0.0,
                          conv_dropout=0.0)
    v, cfg = _hold_to_jax(jcfg)
    # the round trip of the weights, both ways, bit for bit
    sd = state_dict_from_jax(v, cfg)
    back = jax_variables_from_state_dict(sd, cfg)
    for coll in ("params", "batch_stats"):
        jax.tree.map(np.testing.assert_array_equal, back[coll], v[coll])
    own = WiFlowPoseModel(cfg, device="cpu").state_dict()
    assert sorted(k for k in own if not k.endswith("num_batches_tracked")) \
        == sorted(sd)


def test_variant_modules():
    base = ModelConfig(**SMALL)
    plain = WiFlowPoseModel(dataclasses.replace(base, tcn_conv="plain"),
                            device="cpu")
    depth = WiFlowPoseModel(dataclasses.replace(base, tcn_conv="depthwise"),
                            device="cpu")
    for lv, n_in, n_out in zip(depth.tcn.network, (40, 40), (40, 240)):
        assert lv.conv1_group.groups == n_in and lv.conv2_group.groups == n_out
    assert all(lv.conv1_group.groups == lv.conv2_group.groups == 1
               for lv in plain.tcn.network)
    conv2d = WiFlowPoseModel(dataclasses.replace(base, encoder_kind="conv2d"),
                             device="cpu")
    assert not hasattr(conv2d, "tcn") and len(conv2d.encoder2d.blocks) == 5
    none = WiFlowPoseModel(dataclasses.replace(base, use_attention=False),
                           device="cpu")
    assert none.attention is None
    assert not any(k.startswith("attention.") for k in none.state_dict())
    for bad in (dict(tcn_conv="dense"), dict(encoder_kind="tcn")):
        with pytest.raises(ValueError, match=next(iter(bad))):
            ModelConfig(**bad)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_best_weights_files(tmp_path, name):
    cfg = ModelConfig(**SMALL, **VARIANTS[name])
    sd = WiFlowPoseModel(cfg, device="cpu").state_dict()
    checkpoint.save_best_model(str(tmp_path), sd, cfg)
    files = sorted(os.listdir(tmp_path))
    if cfg.encoder_kind == "wiflow":
        assert files == ["best_pose_model.msgpack", "best_pose_model.pth"]
    else:
        assert files == ["best_pose_model.msgpack"]
    back = checkpoint.load_best_model(
        str(tmp_path / "best_pose_model.msgpack"), cfg)
    for k, t in back.items():
        assert torch.equal(t, sd[k]), k


@pytest.mark.parametrize("name", ["tcn_plain", "group_depthwise"])
def test_fused_tcn_variant_matches_jax_fused_model(name):
    """The JAX side through its Pallas stage kernels (interpret mode)."""
    jcfg = JaxModelConfig(**SMALL, **VARIANTS[name], **FUSED_TCN,
                          dropout=0.0, conv_dropout=0.0)
    _, cfg = _hold_to_jax(jcfg)
    assert cfg.tcn_train_impl == "fused"


@pytest.mark.parametrize("name", ["tcn_plain", "group_depthwise"])
def test_fused_tcn_variant_equals_stock_step_with_dropout_on(name):
    kw = dict(SMALL, **VARIANTS[name])
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 40, 20)).astype(np.float32))
    y = torch.from_numpy((0.3 * np.tanh(rng.standard_normal(
        (6, 15, 2)))).astype(np.float32))
    out = []
    for impl in ("xla", "fused"):
        state = create_train_state(ModelConfig(**kw, tcn_train_impl=impl),
                                   OptimConfig(), seed=7, device="cpu")
        assert state.model.tcn.network[0].fused == (impl == "fused")
        m = train_step(state, x, y)
        out.append((m, {n: p.grad for n, p in
                        state.model.named_parameters()}))
    (ms, gs), (mf, gf) = out
    for k in ("loss", "position", "bone", "mpe", "grad_norm"):
        _close(mf[k], ms[k], TOL, k)
    floor = 1e-2 * max(float(g.abs().max()) for g in gs.values())
    for n in gs:
        _close(gf[n], gs[n], GRAD_TOL, f"grad {n}", floor)


@pytest.mark.parametrize("tcn_conv", ["plain", "depthwise"])
@pytest.mark.parametrize("batch", [256, 64, 7])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_stage_plan_plans_the_new_tcn_geometries(tcn_conv, batch, dtype):
    cfg = ModelConfig(tcn_conv=tcn_conv)
    stages, _ = step_launches(cfg, batch)
    causal = [s for s in stages if s["kind"] == "causal3"]
    assert len(causal) == 8
    for s in causal:
        assert s["groups"] == (1 if tcn_conv == "plain" else s["ci"])
    chans = {s["ci"] for s in causal}
    assert chans == {540, 440, 340, 240}
    for s in stages:
        g = stage_geometry(s["kind"], s["lead"], s["ci"], s["co"],
                           s["groups"], s["dil"])
        plan = stage_plan(g, dtype)
        for p in (plan.fwd, plan.dgrad, plan.wgrad):
            assert p.smem <= 232_448


def test_pack_fast_refuses_the_ablation_variants():
    for name, over in VARIANTS.items():
        cfg = ModelConfig(**SMALL, **over)
        sd = WiFlowPoseModel(cfg, device="cpu").state_dict()
        if not over:
            assert pack_fast(sd, cfg, device="cpu").config == cfg
            continue
        with pytest.raises(ValueError, match=next(iter(over))):
            pack_fast(sd, cfg, device="cpu")
