"""The port's robustness kit == the JAX package's, on the CPU.

``wiflow_tpu_torch/robustness`` against ``wiflow_tpu/robustness``:

* ``AEStage`` (stages 1, 2 and 5; NCHW in the port, NHWC in JAX) and
  ``DenoiserHPE`` at 1-5 stages: eval and train-mode outputs, running
  statistics, float64 gradients and the weights' round trip, as
  ``tests/test_torch_hpeli_zoo.py::compare`` holds them; ``DenoiserHPE``
  in bf16 too;
* ``train_denoiser_stage`` for two greedy stages, 2 epochs each, with a
  deterministic ``noise_fn`` (a fixed additive tensor) and the same initial
  weights: every weight within 1e-4 of JAX's (absolute, of weights below 1;
  an Adam step is 3e-3), but the conv biases a BatchNorm follows, which get
  no gradient in exact arithmetic and drift by Adam-normalised rounding
  noise on both sides (bounded by lr a step); the frozen prefix unchanged
  bit for bit; the trained stack merged into a ``DenoiserHPE``
  gives the JAX composition's output;
* the numpy noise functions bit-equal to JAX's from the same Generator, the
  torch ones with the JAX tests' statistics (AWGN std, salt-and-pepper
  fractions);
* both filters, and ``evaluate_robustness`` on the same predictions;
* ``train_pose_model`` with the denoiser's weights loaded and frozen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from wiflow_tpu.robustness import denoiser as jax_den
from wiflow_tpu.robustness import evaluate as jax_eval
from wiflow_tpu.robustness import filters as jax_filters
from wiflow_tpu.robustness import noise as jax_noise

from tests.test_torch_baselines import _close
from tests.test_torch_harness import TOL
from tests.test_torch_hpeli_zoo import (  # noqa: F401  (an autouse fixture)
    Layout, _no_jax_dropout, compare,
)
from wiflow_tpu_torch.core.config import Config, OptimConfig, TrainConfig
from wiflow_tpu_torch.models.baselines.hpeli_zoo import (
    state_dict_from_spec, variables_from_spec,
)
from wiflow_tpu_torch.robustness import denoiser as den
from wiflow_tpu_torch.robustness import (
    add_awgn, add_awgn_torch, add_salt_and_pepper_noise,
    add_salt_and_pepper_torch, evaluate_robustness, frozen_denoiser_labels,
    gaussian_filter, mean_filter, merge_denoiser, train_denoiser_stage,
)
from wiflow_tpu_torch.train.loop import train_pose_model


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class _NCHW(fnn.Module):
    """A JAX AE stage on NCHW input, as the port's runs."""

    inner: fnn.Module

    def __call__(self, x, *, train=False):
        y = self.inner(jnp.transpose(x, (0, 2, 3, 1)), train=train)
        return jnp.transpose(y, (0, 3, 1, 2))


# the stage inputs of MM-Fi CSI [*, 3, 114, 10] (pools at stages 1-3)
STAGE_IN = ((3, 114, 10), (16, 57, 5), (32, 28, 2), (32, 14, 1),
            (64, 14, 1))


@pytest.mark.parametrize("stage", [0, 1, 4], ids=["1", "2", "5"])
def test_ae_stage(stage):
    """A stage's encoder and decoder, and from the second stage on the
    bilinear resize of the decoded map (an upsample at stage 2, (56, 4) ->
    (57, 5); a downsample at stage 5, (28, 2) -> (14, 1))."""
    cin, cout, pool = jax_den.STAGE_CHANNELS[stage]
    jm = _NCHW(jax_den.AEStage(cin, cout, pool=pool,
                               resize_decode=stage > 0))
    pm = den.AEStage(cin, cout, pool, resize_decode=stage > 0,
                     generator=torch.Generator().manual_seed(0),
                     device="cpu")
    compare(jm, pm, _x((3, *STAGE_IN[stage]), stage),
            Layout(den.ae_stage_specs(("inner",))), f64_modules=())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_denoiser_hpe(n):
    """The encoder chain under the reference's nested names, the SKUnits
    and the per-stage-count pools, fp32."""
    pm = den.DenoiserHPE(n, compute_dtype="float32", device="cpu")
    compare(jax_den.DenoiserHPE(num_stages=n, compute_dtype="float32"), pm,
            _x((2, 3, 114, 10), n), Layout(pm.spec()))


def test_denoiser_hpe_bf16():
    """The default bf16: the input and the first conv in bf16, the rest
    promoted to fp32 by the conv's bias, as in the JAX package."""
    x = _x((2, 3, 114, 10), 11)
    jm = jax_den.DenoiserHPE(num_stages=2)
    v = jax.tree.map(np.asarray, jm.init({"params": jax.random.key(0)},
                                         jnp.asarray(x), train=False))
    pm = den.DenoiserHPE(2, device="cpu").load_jax_variables(v)
    ref = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, ref, 1e-3, "bf16 output")


def test_stack_round_trip_and_spec():
    sd = den.StackedDenoisingAE(3, device="cpu").state_dict()
    spec = den.StackedDenoisingAE(3, device="cpu").spec()
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == {
        s[0] for s in spec}
    tree = variables_from_spec(sd, spec)
    assert sorted(tree["params"]) == ["stage_0", "stage_1", "stage_2"]
    back = state_dict_from_spec(tree, spec)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def _jax_init_into_port(monkeypatch, clean_nhwc, seed):
    """Make the port's ``train_denoiser_stage`` start from the weights the
    JAX one draws (``StackedDenoisingAE(n).init`` with ``key(seed)``)."""
    real = den.StackedDenoisingAE

    def make(num_stages, *, device=None, generator=None):
        m = real(num_stages, device=device, generator=generator)
        v = jax_den.StackedDenoisingAE(num_stages).init(
            {"params": jax.random.key(seed)},
            jnp.asarray(clean_nhwc[:1]), train=False)
        v = jax.tree.map(np.asarray, v)
        i = num_stages - 1
        sd = state_dict_from_spec(v, den.ae_stage_specs((f"stage_{i}",),
                                                        f"stages.{i}."))
        m.load_state_dict(sd, strict=False)
        return m

    monkeypatch.setattr(den, "StackedDenoisingAE", make)


# the conv biases a BatchNorm follows, and those BatchNorms' running means
DRIFTING = ("encoder.0.bias", "decoder.0.bias", "encoder.1.running_mean",
            "decoder.1.running_mean")


def test_train_denoiser_stage_matches_jax(monkeypatch):
    """Two greedy stages, 2 epochs each, batch 16 over 40 windows (the
    last partial batch dropped), Adam at 3e-3, the noise a fixed additive
    tensor, both targets."""
    clean = np.random.default_rng(3).random((40, 3, 16, 8)).astype(
        np.float32)
    clean_nhwc = np.transpose(clean, (0, 2, 3, 1))
    _jax_init_into_port(monkeypatch, clean_nhwc, seed=5)
    # the codes each stage corrupts: the input, then stage 1's code
    shift = {1: _x((16, 3, 16, 8), 1) * 0.1, 2: _x((16, 16, 8, 4), 2) * 0.1}
    kw = dict(epochs=2, batch_size=16, lr=3e-3, seed=5)

    def jax_noise_fn(stage):
        s = jnp.asarray(np.transpose(shift[stage], (0, 2, 3, 1)))
        return lambda code, key: code + s

    def port_noise_fn(stage):
        s = torch.from_numpy(shift[stage])
        return lambda code, gen: code + s

    def specs(n):
        return [s for i in range(n) for s in den.ae_stage_specs(
            (f"stage_{i}",), f"stages.{i}.")]

    steps = 2 * kw["epochs"] * (len(clean) // kw["batch_size"])

    def close(got, jax_vars, n, what):
        ref = state_dict_from_spec(jax.tree.map(np.asarray, jax_vars),
                                   specs(n))
        for k, a in ref.items():
            if k.endswith(DRIFTING):
                # no gradient in exact arithmetic (a BN follows the bias):
                # Adam moves such a bias by rounding noise, up to lr a step
                # on either side, and its BN's running mean with it
                drift = (got[k] - torch.as_tensor(a)).abs().max().item()
                assert drift <= 1.01 * kw["lr"] * steps, (k, drift)
                continue
            # 1e-4 absolute (of values below 1): a thirtieth of an Adam step
            _close(got[k], a, 1e-4, f"{what} {k}", floor=1.0)
        return ref

    for target in ("noisy", "clean"):
        jv1 = jax_den.train_denoiser_stage(clean_nhwc, 1, jax_noise_fn(1),
                                           target=target, **kw)
        sd1 = train_denoiser_stage(clean, 1, port_noise_fn(1), target=target,
                                   device="cpu", **kw)
        prev = close(sd1, jv1, 1, f"{target} stage 1")
        # stage 2 from the same prefix on both sides (the drifting biases
        # would shift the prefix's eval-mode code)
        jv2 = jax_den.train_denoiser_stage(clean_nhwc, 2, jax_noise_fn(2),
                                           prev_variables=jv1,
                                           target=target, **kw)
        sd2 = train_denoiser_stage(clean, 2, port_noise_fn(2),
                                   prev_state_dict=prev, target=target,
                                   device="cpu", **kw)
        for k, v in prev.items():
            assert torch.equal(sd2[k], v), f"frozen {k} moved"
        close(sd2, jv2, 2, f"{target} stage 2")


def test_trained_denoiser_merges_into_denoiser_hpe():
    """A stack trained by JAX, carried over by its spec and merged into a
    ``DenoiserHPE``: the JAX composition's output."""
    rng = np.random.default_rng(6)
    x = rng.random((4, 3, 114, 10)).astype(np.float32)
    clean = rng.random((32, 114, 10, 3)).astype(np.float32)
    ae = jax_den.train_denoiser_stage(
        clean, 1, lambda z, k: jax_noise.add_awgn_jax(z, .05, k), epochs=1,
        batch_size=16)
    jm = jax_den.DenoiserHPE(num_stages=1, compute_dtype="float32")
    v = jax.tree.map(np.asarray, jm.init({"params": jax.random.key(0)},
                                         jnp.asarray(x), train=False))
    merged = {"params": {**v["params"], "denoiser": ae["params"]},
              "batch_stats": {**v["batch_stats"],
                              "denoiser": ae["batch_stats"]}}
    ref = jm.apply(merged, jnp.asarray(x), train=False)
    assert not np.allclose(ref, jm.apply(v, jnp.asarray(x), train=False))

    pm = den.DenoiserHPE(1, compute_dtype="float32", device="cpu")
    pm.load_jax_variables(v)
    stack = state_dict_from_spec(jax.tree.map(np.asarray, ae),
                                 den.StackedDenoisingAE(1, device="cpu"))
    enc = merge_denoiser(stack, 1)
    assert sorted(enc) == sorted(
        k for k in pm.state_dict() if k.startswith("encoder.")
        and not k.endswith("num_batches_tracked"))
    pm.load_state_dict(enc, strict=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got, ref, TOL, "merged output")
    labels = frozen_denoiser_labels(pm)
    assert labels["encoder"] == "freeze" and labels["skunit1"] == "train"


def test_merge_denoiser_names_every_stage_of_the_chain():
    for n in range(1, 6):
        stack = den.StackedDenoisingAE(n, device="cpu").state_dict()
        enc = merge_denoiser(stack, n)
        hpe = den.DenoiserHPE(n, device="cpu").state_dict()
        assert sorted(enc) == sorted(k for k in hpe
                                     if k.startswith("encoder.")), n


def test_numpy_noise_is_bit_equal_to_jax():
    x = np.random.default_rng(0).random((8, 3, 20, 10)).astype(np.float32)
    for port, ref in ((add_awgn, jax_noise.add_awgn),
                      (add_salt_and_pepper_noise,
                       jax_noise.add_salt_and_pepper_noise)):
        for level in (0.05, 0.3):
            got = port(x, level, np.random.default_rng(7))
            want = ref(x, level, np.random.default_rng(7))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert x.max() < 1.0                    # the input untouched


def test_torch_noise_statistics():
    """The JAX tests' statistics (tests/test_robustness.py): AWGN std =
    level x range, salt and pepper on about ``level`` of the entries."""
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (8, 3, 20, 10)).astype(np.float32))
    resid = add_awgn_torch(x, 0.1, gen) - x
    assert 0.07 < resid.std().item() < 0.13
    assert abs(resid.mean().item()) < 0.01
    flat = torch.full((64, 64), 0.5)
    noisy = add_salt_and_pepper_torch(flat, 0.2, gen)
    assert 0.15 < ((noisy == 0) | (noisy == 1)).float().mean().item() < 0.25
    assert 0.4 < (noisy == 1).float().sum().item() / max(
        (noisy == 0).float().sum().item(), 1) < 2.5
    assert torch.equal(flat, torch.full((64, 64), 0.5))


@pytest.mark.parametrize("k", [3, 5])
def test_filters_match_jax(k):
    x = _x((2, 3, 8, 50), 2)
    for port, ref in ((gaussian_filter, jax_filters.gaussian_filter),
                      (mean_filter, jax_filters.mean_filter)):
        got = port(torch.from_numpy(x), kernel_size=k)
        assert got.dtype == torch.float32 and got.shape == x.shape
        _close(got, ref(x, kernel_size=k), 1e-6, port.__name__)
        _close(port(x, kernel_size=k), got, 0.0, "numpy input")
    const = np.ones((1, 1, 4, 20), np.float32)
    np.testing.assert_allclose(mean_filter(const).numpy(), const, rtol=1e-6)


def _predict(x):
    # recovers the keypoints from the first 30 (noise-corrupted) channels
    return x[:, :30, 0].reshape(-1, 15, 2)


@pytest.mark.parametrize("kind,cleaner,denoise", [
    ("awgn", "none", False), ("salt_pepper", "mean", False),
    ("awgn", "gaussian", True)])
def test_evaluate_robustness_matches_jax(kind, cleaner, denoise):
    """The sweep over 70 windows in batches of 32 (the last partial batch
    dropped), the same predictor on both sides."""
    rng = np.random.default_rng(5)
    kp = rng.standard_normal((70, 15, 2)).astype(np.float32) * 0.1
    csi = np.tile(kp.reshape(70, 30), (1, 18)).reshape(70, 540)
    csi = np.tile(csi[:, :, None], (1, 1, 20)).astype(np.float32)
    kw = dict(noise_levels=(0.0, 0.3), noise_kind=kind, cleaner=cleaner,
              batch_size=32, seed=4)
    ref = jax_eval.evaluate_robustness(
        _predict, csi, kp, denoise_fn=(lambda x: x * 0.9) if denoise
        else None, **kw)
    got = evaluate_robustness(
        _predict, csi, kp, denoise_fn=(lambda x: x * 0.9) if denoise
        else None, device="cpu", **kw)
    assert list(got) == list(ref)
    for level in ref:
        assert sorted(got[level]) == sorted(ref[level])
        for key, want in ref[level].items():
            assert abs(got[level][key] - want) <= 1e-5 * max(abs(want), 1), (
                level, key, got[level][key], want)
    if cleaner == "none" and not denoise:
        assert got[0.0]["pck@0.2"] == 1.0


def test_frozen_denoiser_through_the_trainer():
    """``train_pose_model(init_state_dict=..., frozen_params=("encoder",))``
    keeps the loaded encoder bit for bit while the head trains."""
    rng = np.random.default_rng(0)

    def split(n):
        x = rng.standard_normal((n, 3, 114, 10)).astype(np.float32)
        y = np.concatenate([
            rng.standard_normal((n, 17, 2)).astype(np.float32) * 0.1,
            np.ones((n, 17, 1), np.float32)], axis=-1)
        return x, y

    stack = den.StackedDenoisingAE(
        1, device="cpu", generator=torch.Generator().manual_seed(3))
    enc = merge_denoiser(stack.state_dict(), 1)
    model = den.DenoiserHPE(1, compute_dtype="float32", device="cpu")
    head = {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("regression.fc1")}

    def conf_mse(out, yb):
        conf = yb[..., 2:3]
        loss = ((conf * out - conf * yb[..., :2]) ** 2).mean()
        return loss, {"position": loss, "bone": torch.zeros_like(loss)}

    cfg = Config(train=TrainConfig(
        batch_size=8, num_epochs=1, optim=OptimConfig(
            lr=1e-2, kind="sgd", momentum=0.0, grad_clip_norm=None,
            schedule="linear_decay")))
    res = train_pose_model(split(16), split(8), split(8), cfg, None,
                           model=model, loss_fn=conf_mse,
                           to_keypoints=lambda out, yb: (out, yb[..., :2]),
                           init_state_dict=enc, frozen_params=("encoder",),
                           verbose=False)
    for k, v in enc.items():
        if k in dict(model.named_parameters()):
            assert torch.equal(res.state_dict[k], v), k
    assert any(not torch.equal(res.state_dict[k], v)
               for k, v in head.items())
    assert np.isfinite(res.history["train_loss"][0])
