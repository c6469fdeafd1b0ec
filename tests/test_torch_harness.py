"""Parity harness shared by the port's tests, and checks of the harness.

The port's tests build a JAX model, perturb its BN running statistics so
that BN folding is exercised, and hand the same numpy arrays to the JAX
package and to ``wiflow_tpu_torch``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models.wiflow import WiFlowPoseModel as JaxModel

from wiflow_tpu_torch.core.config import ModelConfig

# fp32 tolerance tests/test_fast_path.py uses for the same kernels
TOL = 2e-4
# A few narrow layers; 240 features into the conv stack is the smallest
# width the JAX kernel's chunk plan tiles.
SMALL = dict(num_subcarriers=40, tcn_channels=(40, 240), tcn_groups=4,
             conv_channels=(4, 8, 16, 32), attention_groups=4,
             compute_dtype="float32")


def nontrivial_stats(variables, scale=0.2):
    """Perturb running stats so BN folding is exercised (numpy version of
    tests/test_fast_path.py::_nontrivial_stats)."""
    def bump(tree):
        out = {}
        for k, a in tree.items():
            if isinstance(a, dict):
                out[k] = bump(a)
            elif k == "running_mean":
                out[k] = a + scale * np.sin(np.arange(a.size, dtype=a.dtype))
            elif k == "running_var":
                out[k] = a * (1.0 + 0.5 * np.cos(
                    np.arange(a.size, dtype=a.dtype)) ** 2)
            else:
                out[k] = a
        return out
    return {"params": variables["params"],
            "batch_stats": bump(variables["batch_stats"])}


def jax_model(jcfg, seed=0):
    """The flax ``WiFlowPoseModel`` and its variables as numpy arrays,
    running stats perturbed."""
    model = JaxModel(jcfg)
    x = jnp.zeros((1, jcfg.num_subcarriers, jcfg.window_size))
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(seed)}, x)
    return model, nontrivial_stats(jax.tree.map(np.asarray, v))


def port_config(jcfg) -> ModelConfig:
    """The port's ``ModelConfig`` with the JAX config's values."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def test_port_defaults_equal_jax_defaults():
    jcfg = JaxModelConfig()
    for f in dataclasses.fields(ModelConfig):
        assert getattr(ModelConfig(), f.name) == getattr(jcfg, f.name), f.name


def test_nontrivial_stats_moves_every_running_stat():
    bs = {"a": {"running_mean": np.zeros(4, np.float32),
                "running_var": np.ones(4, np.float32)}}
    out = nontrivial_stats({"params": {}, "batch_stats": bs})["batch_stats"]
    mean, var = out["a"]["running_mean"], out["a"]["running_var"]
    np.testing.assert_allclose(mean, 0.2 * np.sin(np.arange(4)), rtol=1e-6)
    assert (var >= 1.0).all() and var[0] == 1.5
    assert bs["a"]["running_mean"].sum() == 0      # input left untouched
