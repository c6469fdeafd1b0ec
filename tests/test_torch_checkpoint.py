"""Checkpoint files of the port against the JAX package's, on the CPU.

* The JAX ``save_best_model``'s ``.msgpack``, read by the port, equals
  ``to_torch_state_dict`` of the same variables exactly; the port's
  msgpack writer gives flax's bytes for the same tree.
* The port's ``.msgpack``, read by the JAX ``load_best_model``, gives the
  port module's forward to 2e-4 (``TOL``, fp32) through the flax model.
* ``jax_variables_from_state_dict`` is the exact inverse of
  ``state_dict_from_jax``.
* A bundle written by ``save_checkpoint`` reads back with the same values;
  a crash between the ``.tmp`` write and ``os.replace`` leaves the old
  bundle readable.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from wiflow_tpu.core import checkpoint as jax_checkpoint
from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models.torch_compat import to_torch_state_dict

from tests.test_torch_harness import SMALL, TOL, jax_model, port_config
from wiflow_tpu_torch.core import checkpoint, flax_msgpack
from wiflow_tpu_torch.models.torch_compat import (
    jax_variables_from_state_dict, load_state_dict, state_dict_from_jax,
)
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.models.wiflow_mmfi import (
    MMFiModelConfig, WiFlowMMFiModel,
)

CONFIGS = {"small": SMALL, "default": dict(compute_dtype="float32")}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pool in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_msgpack_read_by_the_port_equals_to_torch_state_dict(
        name, tmp_path):
    jcfg = JaxModelConfig(**CONFIGS[name])
    _, v = jax_model(jcfg)
    jax_checkpoint.save_best_model(str(tmp_path), v, jcfg)
    ref = to_torch_state_dict(v, jcfg)
    for path in ("best_pose_model.msgpack", "best_pose_model.pth"):
        sd = checkpoint.load_best_model(str(tmp_path / path),
                                        port_config(jcfg))
        assert sorted(sd) == sorted(ref), path
        for k, a in ref.items():
            np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)


def test_port_msgpack_read_by_jax_gives_the_port_forward(tmp_path):
    jcfg = JaxModelConfig(**SMALL)
    model, v = jax_model(jcfg)
    cfg = port_config(jcfg)
    port = load_state_dict(WiFlowPoseModel(cfg, device="cpu"),
                           state_dict_from_jax(v, cfg))
    checkpoint.save_best_model(str(tmp_path), port.state_dict(), cfg)
    restored = jax_checkpoint.load_best_model(
        str(tmp_path / "best_pose_model.msgpack"))
    x = np.random.default_rng(3).standard_normal(
        (5, cfg.num_subcarriers, cfg.window_size)).astype(np.float32)
    ref = np.asarray(model.apply(restored, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), err
    # the .pth beside it is the module's own state_dict
    pth = checkpoint.load_best_model(str(tmp_path / "best_pose_model.pth"))
    for k, t in port.state_dict().items():
        assert torch.equal(pth[k], t), k


@pytest.mark.parametrize("cfg", [port_config(JaxModelConfig(**SMALL)),
                                 MMFiModelConfig(compute_dtype="float32")],
                         ids=["wiflow", "mmfi"])
def test_msgpack_writer_is_flax_bytes_and_inverse_is_exact(cfg):
    cls = WiFlowMMFiModel if isinstance(cfg, MMFiModelConfig) \
        else WiFlowPoseModel
    module = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    sd = module.state_dict()
    tree = jax_variables_from_state_dict(sd, cfg)
    back = state_dict_from_jax(tree, cfg)
    for k, t in back.items():
        assert torch.equal(t, sd[k]), k
    assert flax_msgpack.dumps(checkpoint._sorted(tree)) == \
        serialization.msgpack_serialize(tree)
    restored = flax_msgpack.loads(serialization.msgpack_serialize(tree))
    assert jax.tree.all(jax.tree.map(np.array_equal, restored, tree))


def test_msgpack_reader_refuses_what_flax_does_not_write():
    with pytest.raises(ValueError, match="outside the subset"):
        flax_msgpack.loads(b"\xcb" + b"\0" * 8)       # a float64
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(flax_msgpack.dumps({"a": np.ones(4)})[:-3])
    with pytest.raises(ValueError, match="a .pth or a .msgpack"):
        checkpoint.load_best_model("weights.bin")


def _bundle(seed):
    rng = np.random.default_rng(seed)
    return {"model": {"w": torch.from_numpy(rng.standard_normal((3, 4))
                                            .astype(np.float32))},
            "optimizer": {"state": {0: {"step": torch.tensor(7.0)}},
                          "param_groups": [{"lr": 1e-4, "params": [0]}]},
            "history": {"train_loss": [float(v) for v in rng.random(3)]},
            "array": rng.random(5), "epoch": seed}


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif torch.is_tensor(a):
        assert torch.equal(a, b) and b.device.type == "cpu"
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_bundle_round_trip(tmp_path):
    path = str(tmp_path / "latest_checkpoint.pkl")
    assert checkpoint.load_checkpoint(path) is None
    payload = _bundle(0)
    checkpoint.save_checkpoint(path, payload)
    _same(payload, checkpoint.load_checkpoint(path))
    assert not os.path.exists(path + ".tmp")


def test_crash_before_replace_leaves_the_old_bundle(tmp_path, monkeypatch):
    path = str(tmp_path / "latest_checkpoint.pkl")
    old = _bundle(1)
    checkpoint.save_checkpoint(path, old)

    def crash(src, dst):
        raise KeyboardInterrupt("killed between the write and the rename")

    monkeypatch.setattr(checkpoint.os, "replace", crash)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint(path, _bundle(2))
    monkeypatch.undo()
    _same(old, checkpoint.load_checkpoint(path))
    with open(path + ".tmp", "rb") as f:           # the new one, unrenamed
        assert pickle.load(f)["epoch"] == 2
