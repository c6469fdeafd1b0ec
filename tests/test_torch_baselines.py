"""The port's baselines == the JAX package's, on the CPU, in fp32.

Every baseline class at the JAX tests' small configs (WiSPPN
``layers=(1,1,1,1)``, ``widths=(32,32,64,64)``; WPformer
``trunk_widths=(8,16)``, ``trunk_blocks=(1,1)``; PerUnet a small ``base``)
and HPE-Li at its published size: the flax variables (running statistics
perturbed) go through ``models/baselines/convert.py``, the same numpy
input through both, and

* the eval output within ``TOL`` (2e-4) x max|ref|;
* the train-mode output (batch statistics; dropout 0: WPformer's
  transformer hard-wires 0.1, so both sides' dropout modules are set to
  rate 0 for the comparison) and the updated running statistics within
  ``TOL``;
* every parameter's train-mode gradient of ``sum(out * g)`` within 1e-3 x
  max|ref| (floored at 1e-2 of the largest gradient, for leaves that are
  near 0 in exact arithmetic), both sides in float64 with the BatchNorm
  moments at the input's precision.  In fp32 both packages round the
  moments, in different orders, and these models' train-mode gradients
  amplify that rounding: on some leaves (HPE-Li's
  ``skunit2.sk.conv1_weight``, WiSPPN's BatchNorm biases) the two fp32
  gradients differ by more than 1e-3 of the leaf's largest entry, while
  in float64 they agree far inside it;
* the round trip ``flax_variables_from_state_dict`` bit for bit.

Also the pieces: every PAM function, each bilinear upsample the models
take, XLA's SAME padding at stride 2, the Performer on the JAX
projections, the adaptive pool, the ResNet34 warm start and the PAM
``.mat`` loader on files the test writes.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from wiflow_tpu.data import pam as jax_pam
from wiflow_tpu.models import baselines as jb
from wiflow_tpu.models.baselines import perunet as jax_perunet
from wiflow_tpu.models.baselines import wpformer as jax_wpformer
from wiflow_tpu.models.baselines.hpeli import conv2d as jax_conv2d
from wiflow_tpu.models.baselines.performer import (
    orthogonal_random_features,
)
from wiflow_tpu.models import layers as jax_layers
from wiflow_tpu.models.layers import TorchDropout as JaxTorchDropout

from tests.test_torch_harness import TOL, nontrivial_stats
from wiflow_tpu_torch.data import pam
from wiflow_tpu_torch.models import baselines as pb
from wiflow_tpu_torch.models.baselines import perunet, wisppn, wpformer
from wiflow_tpu_torch.models.baselines.convert import (
    flax_variables_from_state_dict, load_flax_variables,
    state_dict_from_flax,
)
from wiflow_tpu_torch.models.baselines.hpeli import conv2d
from wiflow_tpu_torch.models import layers as port_layers
from wiflow_tpu_torch.models.layers import TorchDropout
from wiflow_tpu_torch.ops.norm import running_update

GRAD_TOL = 1e-3


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


class _NoDropout(JaxTorchDropout):
    """The JAX package's dropout module at rate 0, for a train-mode
    comparison of a model that hard-wires its rates."""

    def __call__(self, x, *, train):
        return x


def _compare(jax_model, port_model, x, projections=None, seed=0,
             grads=True):
    """Hold ``port_model`` to ``jax_model`` on ``x``: eval output,
    train-mode output, running statistics and gradients, and the round
    trip of the weights.  ``projections()``: the Performer projections
    JAX draws (in float64 under x64, as its float64 run draws them)."""
    projections = projections or dict
    v = jax.jit(functools.partial(jax_model.init, train=False))(
        {"params": jax.random.key(seed)}, jnp.asarray(x))
    v = nontrivial_stats(jax.tree.map(np.asarray, v))
    assert sum(p.numel() for p in port_model.parameters()) == sum(
        np.size(p) for p in jax.tree.leaves(v["params"]))
    load_flax_variables(port_model, v, projections())
    sd = port_model.state_dict()
    back = flax_variables_from_state_dict(sd, port_model)
    for coll in ("params", "batch_stats"):
        jax.tree.map(np.testing.assert_array_equal, back[coll], v[coll])

    ref = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
        v, jnp.asarray(x))
    port_model.eval()
    with torch.no_grad():
        got = port_model(torch.from_numpy(x))
    _close(got, ref, TOL, "eval output")
    for m in port_model.modules():
        if isinstance(m, TorchDropout):
            m.rate = 0.0
    rng = np.random.default_rng(seed + 1)
    gv = rng.standard_normal(np.shape(ref)).astype(np.float32)

    def train_step(jm, var, xx):
        def loss(p):
            y, st = jm.apply({"params": p, "batch_stats": var["batch_stats"]},
                             jnp.asarray(xx), train=True,
                             mutable=["batch_stats"])
            return jnp.sum(y * gv), (y, st)
        return jax.jit(jax.grad(loss, has_aux=True))(var["params"])

    ref_y, ref_st = jax.jit(lambda v, x: jax_model.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    port_model.train()
    with torch.no_grad():
        y = port_model(torch.from_numpy(x))
    _close(y, ref_y, TOL, "train output")
    st = state_dict_from_flax({"batch_stats": jax.tree.map(
        np.asarray, ref_st["batch_stats"])})
    now = port_model.state_dict()
    stat_floor = 1e-3 * max(float(np.abs(a).max()) for a in st.values())
    for k, a in st.items():
        _close(now[k], a, TOL, k, stat_floor)

    if not grads:
        return
    # gradients in float64, the BatchNorm moments too (module docstring)
    port_model.double()
    for m in port_model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = "float64"
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        load_flax_variables(port_model, v, projections())
        mp.setattr(jax_layers, "batch_norm_train", _jax_bn_at_input_precision)
        mp.setattr(port_layers, "batch_norm_train",
                   _port_bn_at_input_precision)
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        jm64 = (jax_model.clone(compute_dtype="float64")
                if hasattr(jax_model, "compute_dtype") else jax_model)
        ref_grads, _ = train_step(jm64, v64, x.astype(np.float64))
        ref_grads = jax.tree.map(np.asarray, ref_grads)
        y = port_model(torch.from_numpy(x).double())
        (y * torch.from_numpy(gv).double()).sum().backward()
    grads = state_dict_from_flax({"params": ref_grads})
    floor = 1e-2 * max(float(np.abs(g).max()) for g in grads.values())
    named = dict(port_model.named_parameters())
    assert sorted(named) == sorted(grads)
    for k, g in grads.items():
        _close(named[k].grad, g, GRAD_TOL, f"grad {k}", floor)


def _jax_bn_at_input_precision(x, gamma, beta, running_mean, running_var,
                               *, channel_axis=-1):
    """``wiflow_tpu.ops.norm.batch_norm_train`` with its moments in
    ``x.dtype`` instead of fp32."""
    axes = tuple(i for i in range(x.ndim) if i != channel_axis % x.ndim)
    mean = jnp.mean(x, axis=axes)
    var = jnp.mean(jnp.square(x), axis=axes) - jnp.square(mean)
    n = int(np.prod([x.shape[i] for i in axes]))
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    a = (gamma * jax.lax.rsqrt(var + 1e-5)).astype(x.dtype)
    y = (x - mean.reshape(shape)) * a.reshape(shape) + beta.astype(
        x.dtype).reshape(shape)
    return (y, 0.9 * running_mean + 0.1 * mean,
            0.9 * running_var + 0.1 * var * (n / max(n - 1, 1)))


def _port_bn_at_input_precision(x, gamma, beta, running_mean, running_var):
    """``wiflow_tpu_torch.ops.norm.batch_norm_train`` with its moments in
    ``x.dtype`` instead of fp32."""
    axes = tuple(range(x.ndim - 1))
    mean = x.mean(dim=axes)
    var = (x * x).mean(dim=axes) - mean * mean
    a = (gamma * torch.rsqrt(var + 1e-5)).to(x.dtype)
    y = (x - mean) * a + beta.to(x.dtype)
    new_mean, new_var = running_update(running_mean, running_var,
                                       mean.detach(), var.detach(),
                                       x.numel() // x.shape[-1])
    return y, new_mean, new_var


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_hpeli_at_its_published_size():
    _compare(jb.HPELiNet(compute_dtype="float32"),
             pb.HPELiNet(compute_dtype="float32", device="cpu"),
             _x((4, 540, 20)))


def test_hpeli_mmfi():
    _compare(jb.HPELiMMFi(compute_dtype="float32"),
             pb.HPELiMMFi(compute_dtype="float32", device="cpu"),
             _x((4, 3, 114, 10)))


SMALL_WISPPN = dict(layers=(1, 1, 1, 1), widths=(32, 32, 64, 64),
                    compute_dtype="float32")


def test_wisppn_small():
    """Values and running statistics of the whole model; its gradients in
    float64 block by block (below): JAX's float64 convolutions on the CPU
    take minutes for the fixed 600-channel stem at 120x120."""
    _compare(jb.WiSPPN(**SMALL_WISPPN),
             pb.WiSPPN(**SMALL_WISPPN, device="cpu"), _x((2, 540, 20)),
             grads=False)


@pytest.mark.parametrize("cin,cout,stride", [(24, 16, 1), (16, 16, 2),
                                              (16, 24, 2), (16, 16, 1)])
def test_wisppn_basic_block_gradients(cin, cout, stride):
    _compare(jb.wisppn.BasicBlock(cout, stride=stride),
             pb.wisppn.BasicBlock(cin, cout, stride,
                                  generator=torch.Generator().manual_seed(0),
                                  device="cpu"), _x((2, 15, 15, cin), 2))


def test_wisppn_mmfi_converter_and_17x17_pam():
    """Values and running statistics; the gradients of the blocks behind
    the stem are the wiflow converter's (``test_wisppn_basic_block_*``)."""
    kw = dict(SMALL_WISPPN, input_converter="mmfi", pam_channels=3,
              pam_size=17)
    _compare(jb.WiSPPN(**kw), pb.WiSPPN(**kw, device="cpu"),
             _x((1, 3, 114, 10)), grads=False)


def _jax_projections(depth, prefix, dim_head=64, num_features=256):
    """The projections the JAX layers draw, as a function: they depend on
    whether x64 is on when it is called."""
    return lambda: {f"{prefix}att_{i}": np.asarray(orthogonal_random_features(
        jax.random.key(i), num_features, dim_head)) for i in range(depth)}


@pytest.mark.parametrize("exact", [False, True], ids=["favor", "exact"])
def test_perunet_small(exact):
    kw = dict(base=16, performer_exact=exact, compute_dtype="float32")
    _compare(jb.PerUnet(**kw), pb.PerUnet(**kw, device="cpu"),
             _x((2, 540, 20)), _jax_projections(3, "performer_sc1."))


def test_perunet_mmfi_small():
    kw = dict(base=16, compute_dtype="float32")
    _compare(jb.PerUnetMMFi(**kw), pb.PerUnetMMFi(**kw, device="cpu"),
             _x((2, 3, 114, 10)), _jax_projections(3, "trunk.performer_sc1."))


SMALL_WPFORMER = dict(num_chunks=2, resize_to=(30, 16),
                      trunk_widths=(8, 16), trunk_blocks=(1, 1),
                      compute_dtype="float32")


def test_wpformer_small(monkeypatch):
    monkeypatch.setattr(jax_wpformer, "TorchDropout", _NoDropout)
    _compare(jb.WPformer(**SMALL_WPFORMER),
             pb.WPformer(**SMALL_WPFORMER, device="cpu"), _x((2, 60, 12)))


def test_wpformer_mmfi_small(monkeypatch):
    monkeypatch.setattr(jax_wpformer, "TorchDropout", _NoDropout)
    kw = dict(num_chunks=3, resize_to=(136, 32), num_keypoints=17,
              keypoint_dims=3, trunk_widths=(8, 16, 16, 16),
              trunk_blocks=(1, 1, 1, 1), input_mode="mmfi",
              compute_dtype="float32")
    _compare(jb.WPformer(**kw), pb.WPformer(**kw, device="cpu"),
             _x((2, 3, 114, 10)))


@pytest.mark.parametrize("make,shape", [
    (lambda: pb.HPELiNet(device="cpu"), (2, 540, 20)),
    (lambda: pb.HPELiMMFi(device="cpu"), (2, 3, 114, 10)),
    (lambda: pb.WiSPPN(layers=(1, 1, 1, 1), widths=(8, 8, 16, 16),
                       device="cpu"), (1, 540, 20)),
    (lambda: pb.PerUnet(base=8, device="cpu"), (2, 540, 20)),
    (lambda: pb.PerUnetMMFi(base=8, device="cpu"), (2, 3, 114, 10)),
    (lambda: pb.WPformer(**{**SMALL_WPFORMER, "compute_dtype": "bfloat16"},
                         device="cpu"), (2, 60, 12)),
], ids=["hpeli", "hpeli_mmfi", "wisppn", "perunet", "perunet_mmfi",
        "wpformer"])
def test_bf16_train_step_runs(make, shape):
    """The default compute dtype: bf16 activations, fp32 parameters, with
    JAX's type promotion (an fp32 bias or matrix promotes the product),
    forward and backward in train mode."""
    model = make()
    model.train()
    y = model(torch.from_numpy(_x(shape, 4)))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    y.square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


def test_wpformer_mmfi_is_the_published_configuration():
    port = pb.wpformer_mmfi("float32", device="cpu")
    ref = jb.wpformer_mmfi("float32")
    assert port.num_chunks == ref.num_chunks == 3
    assert port.resize_to == tuple(ref.resize_to)
    assert port.tf.spatial == (17, 12) and port.tf.channels == 512
    assert len(port.trunk.names) == sum(ref.trunk_blocks)


def test_performer_on_the_jax_projections():
    x = _x((2, 24, 32), 3) * 0.5
    jm = jb.Performer(dim=32, depth=2, heads=2, dim_head=16)
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x))
    port = pb.Performer(32, depth=2, heads=2, dim_head=16,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    load_flax_variables(port, jax.tree.map(np.asarray, v),
                        _jax_projections(2, "", dim_head=16)())
    ref = jm.apply(v, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    _close(got.detach(), ref, TOL, "performer")


def test_orthogonal_random_features_structure():
    gen = torch.Generator().manual_seed(0)
    w = pb.performer.orthogonal_random_features(gen, 256, 64)
    assert w.shape == (256, 64) and w.dtype == torch.float32
    unit = w / w.norm(dim=1, keepdim=True)
    for i in range(4):                  # each block of 64 rows orthogonal
        blk = unit[64 * i:64 * (i + 1)].double()
        torch.testing.assert_close(
            blk @ blk.T, torch.eye(64, dtype=torch.float64), atol=1e-5,
            rtol=0)
    # chi(64)-distributed norms: mean near sqrt(63.5)
    assert abs(float(w.norm(dim=1).mean()) - 63.5 ** 0.5) < 0.3
    again = pb.performer.orthogonal_random_features(
        torch.Generator().manual_seed(0), 256, 64)
    assert torch.equal(w, again)


@pytest.mark.parametrize("src,dst", [
    ((3, 6), (120, 120)), ((1, 3), (120, 120)), ((15, 15), (17, 17)),
    ((3, 6), (24, 24)), ((1, 3), (24, 24)), ((30, 20), (60, 32)),
    ((114, 10), (136, 32))])
def test_bilinear_upsample_matches_jax_image_resize(src, dst):
    x = _x((2, *src, 3), 5)
    ref = jax.image.resize(jnp.asarray(x), (2, *dst, 3), "bilinear")
    got = wisppn.resize_bilinear(torch.from_numpy(x), dst)
    _close(got, ref, 1e-6, f"resize {src} -> {dst}")


def test_bilinear_refuses_to_downsample():
    with pytest.raises(ValueError, match="upsamples only"):
        wisppn.resize_bilinear(torch.zeros(1, 4, 4, 1), (2, 8))


@pytest.mark.parametrize("size,stride,dil", [
    (120, 2, 1), (60, 2, 1), (15, 2, 1), (24, 1, 1), (45, 2, 1), (21, 1, 3),
    (7, 2, 2)])
def test_same_padding_matches_xla(size, stride, dil):
    x = _x((2, size, size + 1, 3), 6)
    w = _x((3, 3, 3, 4), 7)
    ref = jax_conv2d(jnp.asarray(x), jnp.asarray(w), stride=(stride, stride),
                     dilation=(dil, dil))
    got = conv2d(torch.from_numpy(x),
                 torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                 stride=(stride, stride), dilation=(dil, dil))
    _close(got, ref, TOL, f"SAME {size} stride {stride} dilation {dil}")


def test_conv_transpose_matches_jax():
    x = _x((2, 3, 5, 6), 8)
    w, b = _x((2, 2, 6, 4), 9), _x((4,), 10)
    ref = jax_perunet.conv_transpose2x2(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b))
    got = perunet.conv_transpose2x2(
        torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b))
    _close(got, ref, TOL, "conv_transpose2x2")


@pytest.mark.parametrize("src,dst", [(24, 15), (24, 1), (17, 5), (3, 3)])
def test_adaptive_avg_pool_matches_jax(src, dst):
    x = _x((2, 3, src, src), 11)
    ref = jax_perunet._adaptive_avg_pool(jnp.asarray(x), dst)
    got = perunet.adaptive_avg_pool(torch.from_numpy(x), dst)
    _close(got, ref, 1e-6, f"adaptive pool {src} -> {dst}")


def test_convert_csi_formats_match_jax():
    x = _x((3, 540, 20), 12)
    np.testing.assert_array_equal(
        wisppn.convert_csi_format(torch.from_numpy(x)).numpy(),
        np.asarray(jb.convert_csi_format(jnp.asarray(x))))
    xm = _x((3, 3, 114, 10), 13)
    from wiflow_tpu.models.baselines.wisppn import convert_csi_format_mmfi
    np.testing.assert_array_equal(
        wisppn.convert_csi_format_mmfi(torch.from_numpy(xm)).numpy(),
        np.asarray(convert_csi_format_mmfi(jnp.asarray(xm))))


def test_pam_functions_match_jax():
    rng = np.random.default_rng(14)
    kp = rng.standard_normal((4, 15, 2)).astype(np.float32)
    label = pam.keypoints_to_pam(kp)
    np.testing.assert_array_equal(label, jax_pam.keypoints_to_pam(kp))
    label[:, 2:] = rng.uniform(0, 1, label[:, 2:].shape)   # confidences
    lt = torch.from_numpy(label)
    pred = rng.standard_normal((4, 2, 15, 15)).astype(np.float32)
    got, parts = pam.pam_confidence_mse(torch.from_numpy(pred), lt)
    ref, _ = jax_pam.pam_confidence_mse(jnp.asarray(pred), jnp.asarray(label))
    _close(got, ref, 1e-6, "pam_confidence_mse")
    assert float(parts["bone"]) == 0.0
    one_conf = label[:, :3]                                # a single channel
    got, _ = pam.pam_confidence_mse(torch.from_numpy(pred),
                                    torch.from_numpy(one_conf))
    ref, _ = jax_pam.pam_confidence_mse(jnp.asarray(pred),
                                        jnp.asarray(one_conf))
    _close(got, ref, 1e-6, "pam_confidence_mse, one confidence channel")
    kpp = rng.standard_normal((4, 15, 2)).astype(np.float32)
    got, _ = pam.pam_keypoint_mse(torch.from_numpy(kpp), lt)
    ref, _ = jax_pam.pam_keypoint_mse(jnp.asarray(kpp), jnp.asarray(label))
    _close(got, ref, 1e-6, "pam_keypoint_mse")
    for fn, p in ((pam.pam_diag_keypoints, kpp), (pam.pam_to_keypoints, pred)):
        got = fn(torch.from_numpy(p), lt)
        ref = getattr(jax_pam, fn.__name__)(jnp.asarray(p), jnp.asarray(label))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        wisppn.keypoints_to_pam(torch.from_numpy(kp)).numpy(),
        np.asarray(jb.wisppn.keypoints_to_pam(jnp.asarray(kp))))
    np.testing.assert_array_equal(
        wisppn.extract_keypoints_from_pam(torch.from_numpy(pred)).numpy(),
        np.asarray(jb.extract_keypoints_from_pam(jnp.asarray(pred))))


@pytest.mark.parametrize("spec", [
    dict(labels="keypoints"), dict(labels="pam"),
    dict(labels="pam", pam_target="keypoints")], ids=["kp", "pam", "wpf"])
def test_pam_train_kwargs_dispatch_as_jax(spec):
    got = pam.pam_train_kwargs(spec)
    ref = jax_pam.pam_train_kwargs(spec)
    assert {k: v.__name__ for k, v in got.items()} == \
        {k: v.__name__ for k, v in ref.items()}


def test_load_pam_labels_for_windows(tmp_path):
    rng = np.random.default_rng(15)
    file_ids = ["subject2_walk", "s3_run"]
    w2f = np.array([0, 0, 1, 1, 1])
    w2fr = np.array([0, 7, 3, 4, 12])
    mats = {}
    for i, (f, fr) in enumerate(zip(w2f, w2fr)):
        fid = file_ids[f]
        subject = {0: 2, 1: 3}[int(f)]
        d = tmp_path / f"wisppn_labels{subject}"
        d.mkdir(exist_ok=True)
        m = rng.standard_normal((3, 15, 15)).astype(np.float32)
        scipy.io.savemat(str(d / f"{fid}_dual_cropped_frame_{fr:06d}.mat"),
                         {"jointsMatrix": m})
        mats[i] = m
    idx = np.array([4, 0, 2])
    got = pam.load_pam_labels_for_windows(str(tmp_path), file_ids, w2f,
                                          w2fr, idx)
    ref = jax_pam.load_pam_labels_for_windows(str(tmp_path), file_ids, w2f,
                                              w2fr, idx)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.stack([mats[i] for i in idx]))
    by_map = pam.load_pam_labels_for_windows(
        str(tmp_path), file_ids, w2f, w2fr, idx,
        file_subjects={"subject2_walk": 2, "s3_run": 3})
    np.testing.assert_array_equal(by_map, got)
    with pytest.raises(FileNotFoundError):
        pam.load_pam_labels_for_windows(
            str(tmp_path), file_ids, w2f, w2fr, idx,
            file_subjects={"subject2_walk": 5, "s3_run": 3})
    assert os.path.exists(tmp_path / "wisppn_labels3")


def _fake_resnet34_state_dict(widths=(64, 128, 256), blocks=(3, 4, 6)):
    rng = np.random.default_rng(16)
    sd = {}

    def bn(p, c):
        sd[f"{p}.weight"] = rng.standard_normal(c)
        sd[f"{p}.bias"] = rng.standard_normal(c)
        sd[f"{p}.running_mean"] = rng.standard_normal(c)
        sd[f"{p}.running_var"] = rng.uniform(0.5, 2, c)

    sd["conv1.weight"] = rng.standard_normal((64, 3, 7, 7))
    bn("bn1", 64)
    cin = 64
    for li, (w, n) in enumerate(zip(widths, blocks)):
        for bi in range(n):
            p = f"layer{li + 1}.{bi}"
            sd[f"{p}.conv1.weight"] = rng.standard_normal(
                (w, cin if bi == 0 else w, 3, 3))
            sd[f"{p}.conv2.weight"] = rng.standard_normal((w, w, 3, 3))
            bn(f"{p}.bn1", w)
            bn(f"{p}.bn2", w)
            if bi == 0 and (li > 0 or cin != w):
                sd[f"{p}.downsample.0.weight"] = rng.standard_normal(
                    (w, cin, 1, 1))
                bn(f"{p}.downsample.1", w)
        cin = w
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in sd.items()}


def test_resnet34_warm_start_matches_jax_and_loads():
    sd = _fake_resnet34_state_dict()
    got = pb.wpformer.resnet34_warm_start(sd)
    ref = state_dict_from_flax(jax.tree.map(
        np.asarray, jax_wpformer.resnet34_warm_start(sd)))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    model = pb.WPformer(compute_dtype="float32", num_chunks=4, device="cpu")
    own = model.state_dict()
    merged = wpformer.merge_warm_start(own, got)
    model.load_state_dict(merged)
    assert torch.equal(model.trunk.layer3_0.down_weight,
                       sd["layer3.0.downsample.0.weight"])
    # the stem conv is the model's own, one channel in
    assert torch.equal(model.trunk.stem_weight, own["trunk.stem_weight"])
    with pytest.raises(KeyError, match="not in the model"):
        wpformer.merge_warm_start(own, {"trunk.nope": torch.zeros(1)})
