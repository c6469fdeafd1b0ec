"""The port's HPE-Li model zoo == the JAX package's, on the CPU.

``models/baselines/hpeli_zoo.py`` (the five pose models and the SKNet
units, reference-named, carried by their specs) and
``models/baselines/sknet_trans.py`` (the attention zoo, MultiAxisAttention,
the regression head and DSKNetTrans, flax-named, carried by
``convert.py``'s rules) against ``wiflow_tpu/models/baselines/``: the JAX
variables (running statistics perturbed) go across, the same numpy input
through both, and

* the eval output within ``TOL`` (2e-4) x max|ref|, in fp32;
* the train-mode output (batch statistics; dropout 0 on both sides: the
  models hard-wire 0.1) and the updated running statistics within ``TOL``;
* every parameter's train-mode gradient of ``sum(out * g)`` within 1e-3 x
  max|ref| (floored at 1e-2 of the largest gradient), both sides in
  float64 with the BatchNorm moments at the input's precision (the zoo's
  JAX models cast their input to fp32: the cast goes to float64 there);
* the weights' round trip JAX -> port -> JAX, bit for bit.

Also: ``MultiAxisAttention``'s resize downsampling and upsampling (antialiased,
as ``jax.image.resize``), each SKConv variant, and a reference checkpoint
with the weights the reference never applies.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.models import layers as jax_layers
from wiflow_tpu.models.baselines import hpeli_zoo as jax_zoo
from wiflow_tpu.models.baselines import sknet_trans as jax_st
from wiflow_tpu.models.baselines import wpformer as jax_wpformer

from tests.test_torch_baselines import (
    GRAD_TOL, _NoDropout, _close, _jax_bn_at_input_precision,
    _port_bn_at_input_precision,
)
from tests.test_torch_harness import TOL, nontrivial_stats
from wiflow_tpu_torch.models import layers as port_layers
from wiflow_tpu_torch.models.baselines import hpeli_zoo as zoo
from wiflow_tpu_torch.models.baselines import sknet_trans as st
from wiflow_tpu_torch.models.baselines.convert import (
    flax_variables_from_state_dict, state_dict_from_flax,
)
from wiflow_tpu_torch.models.layers import TorchDropout
from wiflow_tpu_torch.models.torch_compat import load_state_dict


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_jax_dropout(monkeypatch):
    """The JAX zoo's dropouts at rate 0 (the port's are set to 0 by
    ``compare``), for the train-mode comparison."""
    for mod in (jax_st, jax_wpformer):
        monkeypatch.setattr(mod, "TorchDropout", _NoDropout)


class _Float64Jnp:
    """``jax.numpy`` with ``float32`` meaning float64: the zoo's JAX models
    cast their input to fp32, which the float64 gradients must not."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class Layout:
    """How weights go across: by a spec (the reference's names) or by
    ``convert.py``'s flax-path rules."""

    def __init__(self, spec=None):
        self.spec = spec

    def state_dict(self, tree, module):
        if self.spec is None:
            return state_dict_from_flax(tree)
        full = {"params": tree.get("params", {}),
                "batch_stats": tree.get("batch_stats", {})}
        return zoo.state_dict_from_spec(full, self.spec)

    def back(self, sd, module):
        if self.spec is None:
            return flax_variables_from_state_dict(sd, module)
        return zoo.variables_from_spec(sd, self.spec)

    def load(self, module, tree):
        load_state_dict(module, self.state_dict(tree, module))


def compare(jax_model, port_model, x, layout=Layout(), seed=0, grads=True,
            f64_modules=(jax_zoo,), modes=True):
    """Hold ``port_model`` to ``jax_model`` on ``x`` (module docstring).
    ``modes=False``: the JAX module takes no ``train`` flag (the attention
    classes).  Returns the JAX variables."""
    kw = (lambda train: {"train": train}) if modes else (lambda train: {})
    v = jax.jit(functools.partial(jax_model.init, **kw(False)))(
        {"params": jax.random.key(seed)}, jnp.asarray(x))
    v = nontrivial_stats({"batch_stats": {}, **jax.tree.map(np.asarray, v)})
    assert sum(p.numel() for p in port_model.parameters()) == sum(
        np.size(p) for p in jax.tree.leaves(v["params"]))
    layout.load(port_model, v)
    back = layout.back(port_model.state_dict(), port_model)
    for coll in ("params", "batch_stats"):
        jax.tree.map(np.testing.assert_array_equal, back[coll],
                     v.get(coll, {}))

    ref = jax.jit(lambda v, x: jax_model.apply(v, x, **kw(False)))(
        v, jnp.asarray(x))
    port_model.eval()
    with torch.no_grad():
        got = port_model(torch.from_numpy(x))
    _close(got, ref, TOL, "eval output")
    for m in port_model.modules():
        if isinstance(m, TorchDropout):
            m.rate = 0.0
    gv = np.random.default_rng(seed + 1).standard_normal(
        np.shape(ref)).astype(np.float32)

    ref_y, ref_st = jax.jit(lambda v, x: jax_model.apply(
        v, x, mutable=["batch_stats"], **kw(True)))(v, jnp.asarray(x))
    port_model.train()
    with torch.no_grad():
        y = port_model(torch.from_numpy(x))
    _close(y, ref_y, TOL, "train output")
    if v.get("batch_stats"):
        st_sd = layout.state_dict({"params": v["params"], "batch_stats":
                                   jax.tree.map(np.asarray,
                                                ref_st["batch_stats"])},
                                  port_model)
        st_sd = {k: a for k, a in st_sd.items() if ".running_" in k
                 or k.startswith("running_")}
        now = port_model.state_dict()
        floor = 1e-3 * max(float(np.abs(a).max()) for a in st_sd.values())
        for k, a in st_sd.items():
            _close(now[k], a, TOL, k, floor)
    if not grads:
        return v

    port_model.double()
    for m in port_model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = "float64"
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        layout.load(port_model, v)
        mp.setattr(jax_layers, "batch_norm_train", _jax_bn_at_input_precision)
        mp.setattr(port_layers, "batch_norm_train",
                   _port_bn_at_input_precision)
        for mod in f64_modules:
            mp.setattr(mod, "jnp", _Float64Jnp())
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        jm64 = (jax_model.clone(compute_dtype="float64")
                if hasattr(jax_model, "compute_dtype") else jax_model)

        def loss(p):
            y, _ = jm64.apply({"params": p, "batch_stats":
                               v64.get("batch_stats", {})},
                              jnp.asarray(x, jnp.float64),
                              mutable=["batch_stats"], **kw(True))
            return jnp.sum(y * gv)

        ref_grads = jax.tree.map(np.asarray,
                                 jax.jit(jax.grad(loss))(v64["params"]))
        y = port_model(torch.from_numpy(x).double())
        (y * torch.from_numpy(gv).double()).sum().backward()
    named = dict(port_model.named_parameters())
    grads = layout.state_dict({"params": ref_grads,
                               "batch_stats": v.get("batch_stats", {})},
                              port_model)
    grads = {k: g for k, g in grads.items() if k in named}
    assert sorted(named) == sorted(grads)
    floor = 1e-2 * max(float(np.abs(g).max()) for g in grads.values())
    for k, g in grads.items():
        _close(named[k].grad, g, GRAD_TOL, f"grad {k}", floor)
    return v


GEN = dict(generator=torch.Generator().manual_seed(0), device="cpu")

ZOO = {
    "original_hpe": (jax_zoo.OriginalHPE, zoo.OriginalHPE, (2, 3, 114, 10)),
    "basic_cnn": (jax_zoo.BasicCnnHPE, zoo.BasicCnnHPE, (3, 3, 114, 10)),
    "hpe_wipose": (jax_zoo.HPEWiPoseModel, zoo.HPEWiPoseModel,
                   (3, 9, 30, 5)),
    "dsknet_trans_mmfi": (jax_zoo.DSKNetTransMMFi, zoo.DSKNetTransMMFi,
                          (2, 3, 114, 10)),
    "dsknet_trans_wipose": (jax_zoo.DSKNetTransWipose,
                            zoo.DSKNetTransWipose, (4, 9, 30, 5)),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_model(name):
    """Each of the five pose models at its published size, under the
    reference's names (its ``spec()``)."""
    jax_cls, port_cls, shape = ZOO[name]
    port = port_cls(device="cpu")
    compare(jax_cls(), port, _x(shape), Layout(port.spec()))


@pytest.mark.parametrize("pool_dim", ["freq-chan", "freq", "freq-time"])
def test_sk_unit_selective(pool_dim):
    """SKNet.py's SKUnit under each branch attention, its view quirks
    kept."""
    x = _x((2, 8, 12, 6), 3)
    jm = jax_zoo.SKUnitSelective(16, 16, pool_dim=pool_dim)
    pm = zoo.SKUnitSelective(8, 16, 16, pool_dim, hw=(12, 6), **GEN)
    spec = zoo.sk_unit_selective_spec("", (), pool_dim=pool_dim)
    spec = [(k[1:], *rest) for k, *rest in spec]     # no top-level prefix
    compare(jm, pm, x, Layout(spec))


def test_sk_unit_v2():
    x = _x((2, 16, 10, 4), 4)
    jm = jax_zoo.SKUnitV2(32, 32, m=2, groups=8, r=4)
    pm = zoo.SKUnitV2(16, 32, 32, m=2, groups=8, r=4, **GEN)
    spec = [(k[1:], *rest) for k, *rest in zoo.sk_unit_v2_spec("", (), 2)]
    compare(jm, pm, x, Layout(spec))


@pytest.mark.parametrize("in_shape,kp", [((3, 114, 10), 17), ((9, 30, 5), 18)],
                         ids=["mmfi", "wipose"])
def test_dsknet_trans(in_shape, kp):
    """sknet_trans.py's DSKNetTrans (flax names, ``convert.py``), at narrow
    widths."""
    kw = dict(num_keypoints=kp, num_lay=16, hidden_reg=8, branches=3,
              compute_dtype="float32")
    compare(jax_st.DSKNetTrans(**kw),
            st.DSKNetTrans(**kw, in_shape=in_shape, **GEN),
            _x((2, *in_shape), 5), f64_modules=())


ATTENTION = {
    "self": (lambda: jax_st.SelfAttention(24),
             lambda: st.SelfAttention(24, **GEN), (2, 7, 24)),
    "scaled_dot_product": (
        lambda: jax_st.SelfAttention(24, scale_by_query=True),
        lambda: st.SelfAttention(24, True, **GEN), (2, 7, 24)),
    "multi_head": (lambda: jax_st.MultiHeadAttention(24, 4),
                   lambda: st.MultiHeadAttention(24, 4, **GEN), (2, 7, 24)),
    "additive": (lambda: jax_st.AdditiveAttention(12),
                 lambda: st.AdditiveAttention(12, **GEN), (2, 12, 12)),
    "global_context": (lambda: jax_st.GlobalContextAttention(24),
                       lambda: st.GlobalContextAttention(24, **GEN),
                       (2, 7, 24)),
    "encoder_layer": (lambda: jax_st.TransformerEncoderLayer(24, 4, 40),
                      lambda: st.TransformerEncoderLayer(24, 4, 40, **GEN),
                      (2, 7, 24)),
    "regression_head": (lambda: jax_st.RegressionHead(10, 8),
                        lambda: st.RegressionHead(3 * 5 * 4, 10, 8, **GEN),
                        (6, 3, 5, 4)),
}


@pytest.mark.parametrize("name", sorted(ATTENTION))
def test_attention_zoo(name):
    """Each attention class of sknet_trans.py, the transformer layer and the
    regression head."""
    jax_make, port_make, shape = ATTENTION[name]
    compare(jax_make(), port_make(), _x(shape, 6), f64_modules=(),
            modes=name in ("encoder_layer", "regression_head"))


@pytest.mark.parametrize("f,e", [(114, 64), (10, 32)],
                         ids=["downsample", "upsample"])
def test_multi_axis_attention(f, e):
    """MultiAxisAttention: its output's frequency axis resized to e // 2
    rows, from 114 (a downsample, antialiased as JAX's resize) or from 10
    (an upsample)."""
    kw = dict(num_heads=4, depth=1, dim_feedforward=24)
    compare(jax_st.MultiAxisAttention(e, **kw),
            st.MultiAxisAttention(3, e, **kw, **GEN), _x((2, f, 3, 3), 7),
            f64_modules=())


@pytest.mark.parametrize("src,dst", [(114, 32), (114, 57), (114, 228),
                                      (10, 32), (57, 28), (5, 5)])
def test_resize_rows_matches_jax_image_resize(src, dst):
    x = _x((2, src, 10, 8), 8)
    ref = jax.image.resize(jnp.asarray(x), (2, dst, 10, 8), "linear")
    got = st.resize_rows(torch.from_numpy(x), dst)
    _close(got, ref, 1e-5, f"{src} -> {dst}")


def test_reference_checkpoint_loads_without_its_dead_weights():
    """A reference OriginalHPE / HPEWiPoseModel ``state_dict`` holds
    ``conv3`` / ``shortcut`` (and ``skunit4``) weights that its forward never
    applies: ``load_state_dict`` (strict) drops them by name and loads the
    rest, which give the JAX model's output."""
    x = _x((2, 3, 114, 10), 9)
    jm = jax_zoo.OriginalHPE()
    v = jax.tree.map(np.asarray, jm.init({"params": jax.random.key(1)},
                                         jnp.asarray(x), train=False))
    sd = zoo.state_dict_from_spec(v, zoo.original_hpe_spec())
    for unit in ("skunit1", "skunit2"):
        sd[f"{unit}.conv3.0.weight"] = torch.ones(3, 3, 1, 1)
        sd[f"{unit}.conv3.1.running_mean"] = torch.zeros(3)
        sd[f"{unit}.shortcut.0.weight"] = torch.ones(3, 3, 1, 1)
    pm = zoo.OriginalHPE(device="cpu")
    result = pm.load_state_dict(sd, strict=False)
    assert not result.unexpected_keys
    assert all(k.endswith("num_batches_tracked")
               for k in result.missing_keys)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got, jm.apply(v, jnp.asarray(x), train=False), TOL, "output")

    wp = zoo.HPEWiPoseModel(device="cpu")
    sd = wp.state_dict()
    sd["skunit4.conv1.0.weight"] = torch.ones(1)
    assert not wp.load_state_dict(sd, strict=False).unexpected_keys


def test_zoo_spec_keys_are_the_modules_state_dict():
    """Every model's spec lists exactly its ``state_dict`` keys, less the
    ``num_batches_tracked`` counters."""
    for _, port_cls, _ in ZOO.values():
        m = port_cls(device="cpu")
        keys = {k for k in m.state_dict()
                if not k.endswith("num_batches_tracked")}
        assert keys == {s[0] for s in m.spec()}, port_cls.__name__
