"""The port's slice as a whole == the JAX package, on the CPU, fp32.

* the port's eval module vs ``WiFlowPoseModel.apply(train=False)``;
* the port's ``fast_forward`` (kernels' plain versions on the CPU) vs the
  JAX ``fast_forward`` (Pallas interpret mode) and vs the flax module, at
  a small config and at the default full-width config;
* the port's streaming path vs ``wiflow_tpu.eval.streaming``.

Tolerance 2e-4, as ``tests/test_fast_path.py`` uses for the same path.
"""

import jax.numpy as jnp
import numpy as np
import torch

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.eval.streaming import make_stream_infer as jax_stream
from wiflow_tpu.models.fast import fast_forward as jax_fast_forward

from tests.test_torch_harness import SMALL, TOL, jax_model, port_config
from wiflow_tpu_torch.eval.streaming import make_stream_infer, sliding_windows
from wiflow_tpu_torch.models.fast import fast_forward, pack_fast
from wiflow_tpu_torch.models.torch_compat import (
    load_state_dict, state_dict_from_jax,
)
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel


def _setup(jcfg, seed=0):
    model, v = jax_model(jcfg, seed)
    return model, v, port_config(jcfg)


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (b, cfg.num_subcarriers, cfg.window_size)).astype(np.float32)


def test_module_matches_flax_module_small():
    model, v, cfg = _setup(JaxModelConfig(**SMALL))
    x = _inputs(cfg, 3, 0)
    ref = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    port = load_state_dict(WiFlowPoseModel(cfg, device="cpu"),
                           state_dict_from_jax(v, cfg))
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 15, 2)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_fast_forward_matches_jax_fast_forward_small():
    jcfg = JaxModelConfig(**SMALL)
    _, v, cfg = _setup(jcfg)
    x = _inputs(cfg, 3, 1)
    ref = np.asarray(jax_fast_forward(v, jnp.asarray(x), jcfg,
                                      attention_block=8, interpret=True))
    packed = pack_fast(v, cfg, device="cpu")
    out = fast_forward(packed, torch.from_numpy(x)).numpy()
    assert out.shape == (3, 15, 2) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_fast_forward_matches_flax_module_full_width():
    jcfg = JaxModelConfig(compute_dtype="float32")
    model, v, cfg = _setup(jcfg, seed=1)
    x = _inputs(cfg, 2, 2)
    ref = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    # from the JAX tree and from a torch state_dict: same packed weights
    out = fast_forward(pack_fast(v, cfg, device="cpu"), torch.from_numpy(x))
    out_sd = fast_forward(pack_fast(state_dict_from_jax(v, cfg), cfg,
                                    device="cpu"), torch.from_numpy(x))
    assert out.shape == (2, 15, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(out, out_sd, rtol=0, atol=0)


def test_streaming_matches_jax_streaming():
    jcfg = JaxModelConfig(**SMALL)
    model, v, cfg = _setup(jcfg, seed=2)
    rng = np.random.default_rng(4)
    stream = rng.standard_normal((45, cfg.num_subcarriers)).astype(np.float32)
    ref = np.asarray(jax_stream(
        lambda b: model.apply(v, b, train=False), batch=8)(stream))

    packed = pack_fast(v, cfg, device="cpu")
    infer = make_stream_infer(lambda b: fast_forward(packed, b), batch=8,
                              device="cpu")
    out = infer(stream).numpy()
    assert out.shape == (45 - 19, 15, 2)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)

    win = sliding_windows(torch.from_numpy(stream), 20)
    np.testing.assert_array_equal(win[7].numpy(), stream[7:27].T)
