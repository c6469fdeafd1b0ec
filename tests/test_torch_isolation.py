"""The port stands alone and never drops to the CPU behind the caller's
back: no JAX, no ``wiflow_tpu``, CUDA by default, kernels on the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wiflow_tpu_torch.core.config import ModelConfig, resolve_device
from wiflow_tpu_torch.eval.streaming import make_stream_infer
from wiflow_tpu_torch.models.fast import pack_fast
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.ops.kernels import axial_attention, conv_stack, tcn_level

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ModelConfig(num_subcarriers=40, tcn_channels=(40, 240), tcn_groups=4,
                    conv_channels=(4, 8, 16, 32), attention_groups=4,
                    compute_dtype="float32")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "wiflow_tpu")

_IMPORT_ALL = f"""
import importlib, importlib.util, pkgutil, sys
before = set(sys.modules)
for name in {BLOCKED!r}:
    sys.modules[name] = None          # any import of these now fails
import wiflow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(wiflow_tpu_torch.__path__,
                                               "wiflow_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = [m for m in set(sys.modules) - before
          if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
assert not leaked, leaked
print("imported", len(names))
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_no_jax_and_no_wiflow_tpu():
    r = _run(["-c", _IMPORT_ALL])
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split()[-1])
    assert n >= 15, r.stdout


def test_chip_smoke_fails_without_cuda():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WiFlowPoseModel(SMALL)
    sd = WiFlowPoseModel(SMALL, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pack_fast(sd, SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_stream_infer(lambda b: b)
    assert pack_fast(sd, SMALL, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("module", [tcn_level, conv_stack, axial_attention])
def test_kernel_refuses_instead_of_computing_on_the_cpu(module):
    """Asked for the card where there is none, a kernel raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.KERNEL.load()
    with pytest.raises(RuntimeError, match="CUDA"):
        module.KERNEL.launch()
    assert module.KERNEL.launches == 0


def test_wrappers_reject_other_devices():
    sd = WiFlowPoseModel(SMALL, device="cpu").state_dict()
    packed = pack_fast(sd, SMALL, device="cpu")
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="meta"):
        tcn_level.tcn_level(torch.empty(2, 20, 40, device=meta),
                            packed.tcn[0])
    with pytest.raises(ValueError, match="meta"):
        conv_stack.fused_conv_stack_eval(torch.empty(4, 240, device=meta),
                                         packed.conv)
    with pytest.raises(ValueError, match="meta"):
        axial_attention.dual_axial_attention_eval(
            torch.empty(2, 15, 20, 32, device=meta), packed.attention)
    x = torch.from_numpy(np.zeros((1, 40, 20), np.float32))
    with pytest.raises(ValueError, match="CSI windows"):
        from wiflow_tpu_torch.models.fast import fast_forward
        fast_forward(packed, x[:, :30])
