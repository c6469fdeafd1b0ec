"""``cli/convergence_demo.py::synth_windows`` of the port against the JAX
package's, on the CPU.

The port's observation model (:func:`observe`) is fed the JAX package's
own draws, re-derived here with ``jax.random`` on its key schedule (the
world from ``mix_seed``; the chunk's five keys from ``seed + 1``), at
``n <= chunk``.  Its windows are held to ``wiflow_tpu.cli.
convergence_demo.synth_windows`` in both modes: ``x`` (bf16) within one
bf16 ulp of max|x| (the two frameworks sum the products in other
orders), ``y`` within 4 fp32 ulps of max|y|: XLA's fp32 ``sin`` and its
fused multiply-adds round otherwise than torch's (a third of ``y``'s
entries differ in their last bits; none is equal for every choice of
rounding tried: fused, unfused, through float64).  The port's own draws:
shapes, dtypes, a world the same across splits, other trajectories for
other seeds, chunking that
does not change the windows' distribution.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.cli.convergence_demo import synth_windows as jax_synth

from wiflow_tpu_torch.cli.convergence_demo import (
    SynthWorld, observe, subject_style, synth_windows, synth_world,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_world(c, keypoints, mix_seed, n_paths):
    k2 = 2 * keypoints
    kmix = jax.random.key(mix_seed)
    mix = jax.random.normal(kmix, (2 * k2, c), jnp.float32)
    kp_, ku_, ka_, kph_ = jax.random.split(jax.random.fold_in(kmix, 1), 4)
    return SynthWorld(
        mix=torch.from_numpy(np.asarray(mix)),
        w_path=torch.from_numpy(np.asarray(
            jax.random.normal(kp_, (k2, n_paths)) / jnp.sqrt(k2))),
        u_path=torch.from_numpy(np.asarray(
            jax.random.normal(ku_, (k2, n_paths)) / jnp.sqrt(k2))),
        a_path=torch.from_numpy(np.asarray(
            0.7 + 0.6 * jax.random.uniform(ka_, (n_paths,)))),
        phi=torch.from_numpy(np.asarray(jax.random.uniform(
            kph_, (n_paths, c), maxval=2 * jnp.pi))),
        omega=torch.from_numpy(np.asarray(jnp.linspace(4.0, 16.0, c))))


def _jax_draws(n, seed, c, window, keypoints, subject):
    """The first chunk's draws, as ``gen_chunk`` makes them (chunk = n)."""
    amp_scale, freq_lo, freq_hi, _ = subject_style(subject)
    k2 = 2 * keypoints
    _, sub = jax.random.split(jax.random.key(seed + 1))
    k1, k2_, k3, k4, k5 = jax.random.split(sub, 5)
    d = (0.2 * jax.random.normal(k1, (n, 1, k2)),
         amp_scale * jax.random.normal(k2_, (n, 1, k2)),
         jax.random.uniform(k3, (n, 1, k2), minval=freq_lo, maxval=freq_hi),
         jax.random.uniform(k4, (n, 1, k2), minval=0.0, maxval=2 * jnp.pi),
         jax.random.normal(k5, (n, window, c)))
    return [torch.from_numpy(np.array(a)) for a in d]


@pytest.mark.parametrize("mode", ["linear", "multipath"])
@pytest.mark.parametrize("subject", [0, 4])
def test_observe_on_jax_draws_equals_jax_synth_windows(mode, subject):
    n, c, window, k, seed = 48, 540, 20, 15, 11
    ref_x, ref_y = jax_synth(n, seed, chunk=n, mode=mode, subject=subject)
    ref_x = np.asarray(ref_x.astype(jnp.float32))
    world = _jax_world(c, k, 7, 48)
    x, y = observe(world, *_jax_draws(n, seed, c, window, k, subject),
                   mode=mode, csi_gain=subject_style(subject)[3])
    assert x.dtype == torch.bfloat16 and y.dtype == torch.float32
    assert x.shape == ref_x.shape == (n, c, window)
    # one bf16 ulp of the largest entry (8 bits of mantissa)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(ref_x).max())) - 7)
    assert np.abs(x.float().numpy() - ref_x).max() <= ulp
    ref_y = np.asarray(ref_y)
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=0,
                               atol=4 * np.spacing(np.abs(ref_y).max()))


@pytest.mark.parametrize("mode", ["linear", "multipath"])
def test_port_draws(mode):
    x, y = synth_windows(70, 3, chunk=32, mode=mode, device="cpu")
    assert x.shape == (70, 540, 20) and x.dtype == torch.bfloat16
    assert y.shape == (70, 15, 2) and y.dtype == torch.float32
    assert torch.isfinite(x.float()).all() and torch.isfinite(y).all()
    # poses near 0.5 m, CSI around 1 (the JAX function's scales)
    assert 0.3 < float(y.mean()) < 0.7 and float(y.std()) < 0.5
    assert 0.5 < float(x.float().mean()) < 1.5
    x2, y2 = synth_windows(70, 3, chunk=32, mode=mode, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    _, y3 = synth_windows(70, 4, chunk=32, mode=mode, device="cpu")
    assert not torch.equal(y, y3)


def test_world_is_the_same_across_splits():
    a, b = synth_world(device="cpu"), synth_world(device="cpu")
    for f in ("mix", "w_path", "u_path", "a_path", "phi", "omega"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    c = synth_world(mix_seed=8, device="cpu")
    assert not torch.equal(a.mix, c.mix)
    # splits differ in their trajectories, not in their world: the linear
    # map from [pose, velocity] recovers the same CSI mean for both
    xa, ya = synth_windows(64, 42, device="cpu")
    xb, yb = synth_windows(64, 143, device="cpu")
    assert not torch.equal(ya, yb)


def test_multipath_needs_no_path_intermediate():
    """The paths are added one at a time: memory at most a few [m, T, C]
    tensors, whatever P is (checked by the result at P = 200)."""
    x, _ = synth_windows(8, 0, mode="multipath", n_paths=200, device="cpu")
    assert torch.isfinite(x.float()).all()


def test_bad_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        synth_windows(4, 0, mode="ray", device="cpu")


def test_trainer_stages_tensor_splits_without_numpy(monkeypatch):
    """``train/loop.py::_stage`` takes a split of tensors (bf16, as
    ``synth_windows`` makes them) to the device and dtype directly: no
    host round trip through numpy, which takes neither a CUDA tensor nor
    a bf16 one."""
    from wiflow_tpu_torch.train import loop
    x, y = synth_windows(6, 0, device="cpu")

    def no_numpy(*a, **k):
        raise AssertionError("a tensor split went through numpy")

    monkeypatch.setattr(loop.np, "asarray", no_numpy)
    sx, sy = loop._stage((x, y), torch.device("cpu"), torch.float32)
    assert sx.dtype == torch.float32 and sy.dtype == torch.float32
    assert torch.equal(sx, x.float()) and torch.equal(sy, y)
    bx, _ = loop._stage((x, y), torch.device("cpu"), torch.bfloat16)
    assert bx.data_ptr() == x.data_ptr()          # already there: no copy


def test_trainer_stages_numpy_splits_as_before():
    from wiflow_tpu_torch.train import loop
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 540, 20)).astype(np.float32)
    y = rng.standard_normal((4, 15, 2))             # float64 labels
    sx, sy = loop._stage((x, y), torch.device("cpu"), torch.bfloat16)
    assert sx.dtype == torch.bfloat16 and sy.dtype == torch.float32
    assert torch.equal(sx, torch.from_numpy(x).bfloat16())
    assert torch.equal(sy, torch.from_numpy(y).float())
