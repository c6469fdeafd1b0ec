"""The port's MM-Fi serving path == the JAX package's, on the CPU, fp32.

* exact weight carry-over from the JAX tree (every key of
  ``wiflow_mmfi_spec``, nothing missing or left over);
* ``WiFlowMMFiModel`` in eval mode and the forward of its train mode
  (dropout 0: output and updated running statistics) against the flax
  module;
* ``fast_forward_mmfi`` (the kernels' plain versions on the CPU) against the
  JAX ``fast_forward_mmfi`` (Pallas interpret mode) at a small config and
  against the flax module at full width;
* the five MM-Fi metric functions against the JAX ones.

Tolerance 2e-4 on values, as ``tests/test_fast_path.py`` uses for the same
path; the metrics 1e-5 (``pa_mpjpe`` 1e-4, through two SVDs).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.metrics import mmfi_metrics as jax_metrics
from wiflow_tpu.models.fast import fast_forward_mmfi as jax_fast_forward_mmfi
from wiflow_tpu.models.torch_compat import (
    to_torch_state_dict, wiflow_mmfi_spec as jax_mmfi_spec,
)
from wiflow_tpu.models.wiflow_mmfi import (
    MMFiModelConfig as JaxMMFiConfig, WiFlowMMFiModel as JaxMMFiModel,
)

from tests.test_torch_harness import TOL, nontrivial_stats
from wiflow_tpu_torch.metrics import mmfi_metrics
from wiflow_tpu_torch.models.fast import fast_forward_mmfi, pack_fast_mmfi
from wiflow_tpu_torch.models.torch_compat import (
    load_state_dict, state_dict_from_jax, wiflow_mmfi_spec,
)
from wiflow_tpu_torch.models.wiflow_mmfi import (
    MMFiModelConfig, WiFlowMMFiModel,
)


@dataclasses.dataclass(frozen=True)
class SmallJaxConfig(JaxMMFiConfig):
    """A narrow TCN and conv stack around the MM-Fi geometry the kernels
    see: 272 features into the conv stack, attention on ``[B, 17, 10, C]``.
    (The channel tuples are class attributes of the JAX config.)"""

    tcn_channels = (36, 24)
    conv_channels = (4, 8, 16, 32)


SMALL = dict(num_subcarriers=12, tcn_groups=6, attention_groups=4,
             compute_dtype="float32", attention_module_impl="xla")


def _port_config(jcfg) -> MMFiModelConfig:
    return MMFiModelConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(MMFiModelConfig)})


def _jax_model(jcfg, seed=0):
    model = JaxMMFiModel(jcfg)
    x = jnp.zeros((1, jcfg.num_antennas, jcfg.num_subcarriers,
                   jcfg.window_size))
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(seed)}, x)
    return model, nontrivial_stats(jax.tree.map(np.asarray, v))


def _inputs(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_antennas, cfg.num_subcarriers,
         cfg.window_size)).astype(np.float32)


CONFIGS = {"small": lambda: SmallJaxConfig(**SMALL),
           "full": lambda: JaxMMFiConfig(compute_dtype="float32")}


def test_port_config_defaults_equal_jax_defaults():
    port, ref = MMFiModelConfig(), JaxMMFiConfig()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.input_channels == ref.input_channels == 342


@pytest.mark.parametrize("name", ["tcn_train_impl", "conv_train_impl"])
@pytest.mark.parametrize("impl", ["fused", "auto"])
def test_fused_train_switches_are_not_ported(name, impl):
    """(The name is kept from when the MM-Fi model refused the switches.)
    Each switch builds what it selects on the CPU: ``"fused"`` the fused
    blocks, ``"auto"`` the stock-op ones (it selects the fused path on a
    CUDA device only); the other switch's blocks stay stock ops."""
    cfg = dataclasses.replace(_port_config(SmallJaxConfig(**SMALL)),
                              **{name: impl})
    model = WiFlowMMFiModel(cfg, device="cpu")
    tcn = [lv.fused for lv in model.tcn.network]
    conv = [blk.fused for blk in (model.up, *model.residual_blocks)]
    want = impl == "fused"
    assert tcn == [want and name == "tcn_train_impl"] * len(tcn)
    assert conv == [want and name == "conv_train_impl"] * len(conv)
    assert getattr(MMFiModelConfig(**{name: "xla"}), name) == "xla"
    with pytest.raises(ValueError, match=name):
        MMFiModelConfig(**{name: "pallas"})


def test_weights_carry_over_exactly():
    jcfg = JaxMMFiConfig(compute_dtype="float32")
    _, v = _jax_model(jcfg)
    cfg = _port_config(jcfg)
    sd = state_dict_from_jax(v, cfg)
    # the JAX package's own export gives the same names and values
    ref = to_torch_state_dict(v, spec=jax_mmfi_spec(jcfg))
    assert set(sd) == set(ref) == {s[0] for s in wiflow_mmfi_spec(cfg)}
    for k, a in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)
    module = load_state_dict(WiFlowMMFiModel(cfg, device="cpu"), sd)
    own = module.state_dict()
    assert {k for k in own if not k.endswith("num_batches_tracked")} == set(sd)
    for k, a in sd.items():
        assert own[k].shape == a.shape and torch.equal(own[k], a), k
    assert "att.width_axis.bn_qkv.weight" in sd
    assert "tcn_proj.1.running_var" in sd and "final_conv.3.bias" in sd
    # level 0 keeps its width, so it has no shortcut conv
    assert "tcn.network.0.downsample.0.weight" not in sd
    assert "tcn.network.1.downsample.0.weight" in sd
    broken = {"params": v["params"], "batch_stats": {
        k: a for k, a in v["batch_stats"].items() if k != "tcn_proj_bn"}}
    with pytest.raises(KeyError, match="tcn_proj_bn"):
        state_dict_from_jax(broken, cfg)
    with pytest.raises(KeyError, match="unexpected"):
        load_state_dict(module, {**sd, "attention.extra": sd["final_conv.3.bias"]})


@pytest.mark.parametrize("size", ["small", "full"])
def test_module_matches_flax_module(size):
    jcfg = CONFIGS[size]()
    model, v = _jax_model(jcfg)
    cfg = _port_config(jcfg)
    x = _inputs(cfg, 3 if size == "small" else 2, 0)
    ref = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    port = load_state_dict(WiFlowMMFiModel(cfg, device="cpu"),
                           state_dict_from_jax(v, cfg))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == (x.shape[0], 17, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="MM-Fi CSI"):
        port(torch.from_numpy(x[:, :2]))


def test_train_forward_matches_flax_module():
    jcfg = dataclasses.replace(SmallJaxConfig(**SMALL), dropout=0.0,
                               conv_dropout=0.0)
    model, v = _jax_model(jcfg, seed=1)
    cfg = _port_config(jcfg)
    x = _inputs(cfg, 4, 1)
    ref, mut = model.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    new_v = {"params": v["params"],
             "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])}
    ref_state = state_dict_from_jax(new_v, cfg)

    port = load_state_dict(WiFlowMMFiModel(cfg, device="cpu"),
                           state_dict_from_jax(v, cfg)).train()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    state = port.state_dict()
    stats = [k for k in ref_state if "running" in k]
    assert len(stats) == 2 * len([k for k in state
                                  if k.endswith("num_batches_tracked")])
    floor = 1e-3 * max(float(ref_state[k].abs().max()) for k in stats)
    for k in stats:
        err = float((state[k] - ref_state[k]).abs().max())
        scale = max(float(ref_state[k].abs().max()), floor)
        assert err <= TOL * scale, f"{k}: {err} > {TOL} x {scale}"
    assert all(int(state[k]) == 1 for k in state
               if k.endswith("num_batches_tracked"))
    # back in eval mode the module reads the updated statistics
    ref_eval = model.apply(new_v, jnp.asarray(x), train=False)
    with torch.no_grad():
        out_eval = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out_eval.numpy(), np.asarray(ref_eval),
                               rtol=TOL, atol=TOL)


def test_fast_forward_mmfi_matches_jax_fast_forward_mmfi_small():
    jcfg = SmallJaxConfig(**SMALL)
    _, v = _jax_model(jcfg, seed=2)
    cfg = _port_config(jcfg)
    x = _inputs(cfg, 3, 2)
    ref = np.asarray(jax_fast_forward_mmfi(v, jnp.asarray(x), jcfg,
                                           attention_block=8, interpret=True))
    packed = pack_fast_mmfi(v, cfg, device="cpu")
    out = fast_forward_mmfi(packed, torch.from_numpy(x))
    assert out.shape == (3, 17, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="MM-Fi CSI"):
        fast_forward_mmfi(packed, torch.from_numpy(x[:, :, :5]))


def test_fast_forward_mmfi_matches_flax_module_full_width():
    jcfg = JaxMMFiConfig(compute_dtype="float32")
    model, v = _jax_model(jcfg, seed=3)
    cfg = _port_config(jcfg)
    x = _inputs(cfg, 2, 3)
    ref = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    packed = pack_fast_mmfi(v, cfg, device="cpu")
    assert [lv.dw is None for lv in packed.tcn] == [True, False, False]
    assert [tuple(lv.g1w.shape) for lv in packed.tcn] == [
        (3, 18, 19, 19), (3, 18, 19, 19), (3, 18, 17, 17)]
    # from the JAX tree and from a torch state_dict: same packed weights
    out = fast_forward_mmfi(packed, torch.from_numpy(x))
    out_sd = fast_forward_mmfi(
        pack_fast_mmfi(state_dict_from_jax(v, cfg), cfg, device="cpu"),
        torch.from_numpy(x))
    assert out.shape == (2, 17, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(out, out_sd, rtol=0, atol=0)


def _poses(seed=7, n=64):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((n, 17, 3)).astype(np.float32)
    pred = target + 0.2 * rng.standard_normal((n, 17, 3)).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("name,tol", [
    ("root_relative_pck_fractions", 1e-5), ("root_relative_pck", 1e-5),
    ("root_aligned_mpjpe", 1e-5), ("similarity_transform", 1e-5),
    ("pa_mpjpe", 1e-4)])
def test_mmfi_metric_matches_jax(name, tol):
    pred, target = _poses()
    # a reflected pose: the alignment must not mirror it back
    pred[:8, :, 0] *= -1.0
    args = (pred, target)
    if name == "root_relative_pck_fractions":
        args += ((0.1, 0.2, 0.3, 0.4, 0.5),)
    ref = getattr(jax_metrics, name)(*map(jnp.asarray, args[:2]), *args[2:])
    out = getattr(mmfi_metrics, name)(*map(torch.from_numpy, args[:2]),
                                      *args[2:])
    if name == "root_relative_pck":
        assert list(out) == list(ref)
        out, ref = list(out.values()), list(ref.values())
        assert all(isinstance(v, float) for v in out)
    else:
        assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_similarity_transform_recovers_a_similarity_not_a_reflection():
    pred, target = _poses(seed=8, n=4)
    rot = np.linalg.qr(np.random.default_rng(9).standard_normal((3, 3)))[0]
    rot *= np.sign(np.linalg.det(rot))                  # a proper rotation
    moved = 1.7 * target @ rot.T + np.float32(0.3)
    aligned = mmfi_metrics.similarity_transform(
        torch.from_numpy(moved.astype(np.float32)), torch.from_numpy(target))
    np.testing.assert_allclose(aligned.numpy(), target, atol=2e-5)
    assert float(mmfi_metrics.pa_mpjpe(
        torch.from_numpy(moved.astype(np.float32)),
        torch.from_numpy(target))) < 2e-5
    # a mirror image cannot be rotated back: the error stays
    mirrored = target * np.array([-1.0, 1.0, 1.0], np.float32)
    assert float(mmfi_metrics.pa_mpjpe(torch.from_numpy(mirrored),
                                       torch.from_numpy(target))) > 0.1
