"""Weights carried from the JAX package into the port, exactly."""

import numpy as np
import pytest
import torch

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models.torch_compat import to_torch_state_dict

from tests.test_torch_harness import SMALL, jax_model, port_config
from wiflow_tpu_torch.core.checkpoint import load_best_model
from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.models.torch_compat import (
    load_state_dict, state_dict_from_jax,
)
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel

CONFIGS = {"small": SMALL, "default": dict(compute_dtype="float32")}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_from_jax_equals_to_torch_state_dict(name):
    jcfg = JaxModelConfig(**CONFIGS[name])
    _, v = jax_model(jcfg)
    ref = to_torch_state_dict(v, jcfg)
    sd = state_dict_from_jax(v, port_config(jcfg))
    assert list(sd) == list(ref)
    for k, a in ref.items():
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)

    module = WiFlowPoseModel(port_config(jcfg), device="cpu")
    keys = [k for k in module.state_dict()
            if not k.endswith("num_batches_tracked")]
    assert sorted(keys) == sorted(sd)
    load_state_dict(module, sd)
    for k, t in module.state_dict().items():
        if k in sd:
            torch.testing.assert_close(t, sd[k], rtol=0, atol=0)


def test_load_state_dict_tolerates_only_num_batches_tracked():
    cfg = ModelConfig(**SMALL)
    module = WiFlowPoseModel(cfg, device="cpu")
    sd = {k: v.clone() for k, v in module.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    load_state_dict(module, sd)
    missing = dict(sd)
    missing.pop("decoder.0.weight")
    with pytest.raises(KeyError, match="decoder.0.weight"):
        load_state_dict(module, missing)
    extra = dict(sd, **{"decoder.9.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="decoder.9.weight"):
        load_state_dict(module, extra)


def test_pth_round_trip(tmp_path):
    jcfg = JaxModelConfig(**SMALL)
    _, v = jax_model(jcfg)
    ref = {k: torch.from_numpy(np.ascontiguousarray(a).copy())
           for k, a in to_torch_state_dict(v, jcfg).items()}
    path = str(tmp_path / "best_pose_model.pth")
    torch.save(ref, path)           # what wiflow_tpu's save_best_model writes
    sd = load_best_model(path)
    assert list(sd) == list(ref)
    for k in ref:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    load_state_dict(WiFlowPoseModel(port_config(jcfg), device="cpu"), sd)
    with pytest.raises(ValueError, match="msgpack"):
        load_best_model(str(tmp_path / "best_pose_model.npz"))
