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
from wiflow_tpu_torch.models.fast import (
    fast_forward_mmfi, pack_fast, pack_fast_mmfi,
)
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.models.wiflow_mmfi import (
    MMFiModelConfig, WiFlowMMFiModel,
)
from wiflow_tpu_torch.ops.kernels import (
    axial_attention, axial_attention_train, conv_stack, tcn_level,
)
from wiflow_tpu_torch.train.loop import train_pose_model
from wiflow_tpu_torch.train.steps import create_train_state

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
print(" ".join(names))
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
    for module in ("models.wiflow_mmfi", "metrics.mmfi_metrics",
                   "models.fast", "ops.kernels.axial_attention"):
        assert f"wiflow_tpu_torch.{module}" in r.stdout.split(), module


# What the card's machine lacks: the port and chip_smoke.py import none of
# them when they are imported (artifacts import matplotlib and cv2 inside
# the functions that draw).
HOST_ONLY = ("pandas", "matplotlib", "cv2", "msgpack")


def test_port_imports_without_pandas_matplotlib_cv2_msgpack():
    block = f"for name in {BLOCKED!r}:"
    assert block in _IMPORT_ALL
    r = _run(["-c", _IMPORT_ALL.replace(
        block, f"for name in {BLOCKED + HOST_ONLY!r}:", 1)])
    assert r.returncode == 0, r.stdout + r.stderr
    for module in ("cli.run", "cli.preprocess", "core.flax_msgpack",
                   "data.preprocess", "data.augment", "eval.artifacts",
                   "eval.video"):
        assert f"wiflow_tpu_torch.{module}" in r.stdout.split(), module


# What the card's machine lacks besides: sklearn and PyYAML.  The MM-Fi
# layer draws sklearn's split with numpy and imports PyYAML only for a
# ``--config`` file, OpenCV only for depth frames.
MISSING_ON_THE_CARD = ("sklearn", "yaml", "cv2", "pandas", "matplotlib")

_MMFI_WITHOUT_THEM = """
import os, sys
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from wiflow_tpu_torch.data.mmfi import split_val_test
val, test = split_val_test(95)
assert len(val) == 47 and len(test) == 48
assert sorted(np.concatenate([val, test]).tolist()) == list(range(95))
from wiflow_tpu_torch.cli import run_mmfi
root = sys.argv[1]
rc = run_mmfi.main(["--synthetic", "--dataset_root", os.path.join(root, "t"),
                    "--output_dir", os.path.join(root, "out"), "--epochs",
                    "1", "--device", "cpu", "--compute_dtype", "float32",
                    "--no_videos"])
assert rc == 0, rc
print("ran", sorted(os.listdir(os.path.join(root, "out"))))
"""


def test_port_imports_without_what_the_card_lacks():
    block = f"for name in {BLOCKED!r}:"
    r = _run(["-c", _IMPORT_ALL.replace(
        block, f"for name in {BLOCKED + MISSING_ON_THE_CARD!r}:", 1)])
    assert r.returncode == 0, r.stdout + r.stderr
    for module in ("data.mmfi", "cli.run_mmfi", "metrics.metrics",
                   "eval.artifacts"):
        assert f"wiflow_tpu_torch.{module}" in r.stdout.split(), module


# What the card lacks, and msgpack and h5py besides: the ablation and
# baseline modules import none of them (``data/pam.py`` imports scipy and
# h5py inside ``load_pam_mat`` only).
BASELINE_BLOCKED = MISSING_ON_THE_CARD + ("msgpack", "h5py")
NEW_MODULES = ("cli.ablation_demo", "cli.baseline_table", "cli.run_baseline",
               "cli.convergence_demo", "data.pam", "models.baselines",
               "models.baselines.convert", "models.baselines.hpeli",
               "models.baselines.performer", "models.baselines.perunet",
               "models.baselines.wisppn", "models.baselines.wpformer",
               "utils.flops")


def test_ablation_and_baseline_modules_import_without_them():
    block = f"for name in {BLOCKED!r}:"
    r = _run(["-c", _IMPORT_ALL.replace(
        block, f"for name in {BLOCKED + BASELINE_BLOCKED!r}:", 1)])
    assert r.returncode == 0, r.stdout + r.stderr
    for module in NEW_MODULES:
        assert f"wiflow_tpu_torch.{module}" in r.stdout.split(), module


_BASELINE_CLIS_WITHOUT_THEM = """
import json, os, sys
for name in {blocked!r}:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from wiflow_tpu_torch.cli import (
    ablation_demo, baseline_table, run_baseline, run_mmfi,
)
from wiflow_tpu_torch.data.mmfi import generate_synthetic_mmfi
from wiflow_tpu_torch.data.synthetic import make_preprocessed_dataset
root = sys.argv[1]
cpu = ["--device", "cpu", "--compute_dtype", "float32", "--epochs", "1"]
data = make_preprocessed_dataset(root, num_files=8, frames_per_file=24)
assert run_baseline.main(["--model", "hpeli", "--data_dir", data,
                          "--output_dir", os.path.join(root, "rb"),
                          "--batch_size", "8"] + cpu) == 0
tree = os.path.join(root, "MMFi")
generate_synthetic_mmfi(tree, subjects=("S01", "S02", "S11"), frames=16)
assert run_mmfi.main(["--model", "hpeli", "--dataset_root", tree,
                      "--output_dir", os.path.join(root, "mm"),
                      "--no_videos"] + cpu) == 0
small = ["--windows", "40", "--batch_size", "8"] + cpu
assert baseline_table.main(small + ["--models", "hpeli", "--output_dir",
                                    os.path.join(root, "bt")]) == 0
assert ablation_demo.main(small + ["--variants", "no_attention",
                                   "--output_dir",
                                   os.path.join(root, "ab")]) == 0
with open(os.path.join(root, "bt", "comparison_summary.json")) as fd:
    print("flops", json.load(fd)["rows"][0]["flops_g"])
print("ran", sorted(os.listdir(os.path.join(root, "rb"))))
"""


def test_baseline_and_ablation_clis_run_without_them(tmp_path):
    r = _run(["-c", _BASELINE_CLIS_WITHOUT_THEM.format(
        blocked=BLOCKED + BASELINE_BLOCKED), str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "skipped training_history.png" in r.stdout
    assert "flops 2.153" in r.stdout
    assert "'best_pose_model.msgpack'" in r.stdout.splitlines()[-1]


def test_mmfi_split_and_cli_run_without_what_the_card_lacks(tmp_path):
    r = _run(["-c", _MMFI_WITHOUT_THEM.format(
        blocked=BLOCKED + MISSING_ON_THE_CARD), str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "skipped training_history.png" in r.stdout
    assert "'best_pose_model.pth'" in r.stdout.splitlines()[-1]


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


@pytest.mark.parametrize("kernel", [axial_attention.KERNEL_V1,
                                    axial_attention.KERNEL_DUAL],
                         ids=lambda k: k.symbol)
def test_attention_variant_kernel_refuses_instead_of_computing_on_the_cpu(
        kernel):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel.load()
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel.launch()
    assert kernel.launches == 0
    assert kernel.source == f"wiflow_tpu_torch/csrc/{kernel.name}.cu"
    assert os.path.exists(os.path.join(REPO, kernel.source))


def test_mmfi_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    small = MMFiModelConfig(num_subcarriers=12, tcn_channels=(36, 24),
                            tcn_groups=6, conv_channels=(4, 8, 16, 32),
                            attention_groups=4, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WiFlowMMFiModel(small)
    sd = WiFlowMMFiModel(small, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pack_fast_mmfi(sd, small)
    packed = pack_fast_mmfi(sd, small, device="cpu")
    assert packed.device.type == "cpu"
    out = fast_forward_mmfi(packed, torch.zeros(2, 3, 12, 10))
    assert out.shape == (2, 17, 3) and out.device.type == "cpu"


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
    for fn in (axial_attention.dual_axial_attention_eval_fused,
               axial_attention.dual_axial_attention_eval_v1):
        with pytest.raises(ValueError, match="meta"):
            fn(torch.empty(2, 15, 20, 32, device=meta), packed.attention)
    with pytest.raises(ValueError, match="meta"):
        axial_attention.axial_attention_v1(
            torch.empty(6, 20, 96, device=meta), *packed.attention[0][2:])
    x = torch.from_numpy(np.zeros((1, 40, 20), np.float32))
    with pytest.raises(ValueError, match="CSI windows"):
        from wiflow_tpu_torch.models.fast import fast_forward
        fast_forward(packed, x[:, :30])


def test_train_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(SMALL)
    data = (np.zeros((4, 40, 20), np.float32), np.zeros((4, 15, 2),
                                                           np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_pose_model(data, data, data)
    state = create_train_state(SMALL, device="cpu")
    assert state.model.training
    assert next(state.model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("kernel", axial_attention_train.KERNELS,
                         ids=lambda k: k.symbol)
def test_train_kernel_refuses_instead_of_computing_on_the_cpu(kernel):
    """Asked for the card where there is none, a train kernel raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel.load()
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel.launch()
    assert kernel.launches == 0


def test_train_wrappers_reject_other_devices():
    meta = torch.empty(3, 20, 16, device="meta")
    scale = torch.ones(2, device="meta")
    with pytest.raises(ValueError, match="meta"):
        axial_attention_train.axial_core(meta, meta, meta, scale)
    with pytest.raises(ValueError, match="meta"):
        axial_attention_train.logits_sums(meta, meta, 2)


def test_ablation_and_baseline_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from wiflow_tpu_torch.cli import ablation_demo, baseline_table, run_baseline
    from wiflow_tpu_torch.cli.convergence_demo import synth_windows
    from wiflow_tpu_torch.models import baselines
    for make in (baselines.HPELiNet, lambda: baselines.PerUnet(base=8),
                 lambda: synth_windows(4, 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for main, argv in ((ablation_demo.main, ["--windows", "8"]),
                       (baseline_table.main, ["--windows", "8"]),
                       (run_baseline.main, ["--model", "hpeli"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


# The robustness kit (HPE-Li's zoo, noise, filters, denoisers, WiPose and
# their CLIs): none of it imports JAX, PyYAML (``--config`` imports it when
# given), h5py or mat73 (``load_wipose_mat`` imports them when called), nor
# what the card lacks besides.
KIT_BLOCKED = MISSING_ON_THE_CARD + ("msgpack", "h5py", "mat73")
KIT_MODULES = ("cli.run_robustness", "cli.robustness_demo", "data.wipose",
               "models.baselines.sknet_trans", "models.baselines.hpeli_zoo",
               "robustness", "robustness.denoiser", "robustness.evaluate",
               "robustness.filters", "robustness.noise")

_KIT_CLI_WITHOUT_THEM = """
import json, os, sys
for name in {blocked!r}:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from wiflow_tpu_torch.cli import run_robustness
root = sys.argv[1]
out = os.path.join(root, "out")
assert run_robustness.main(["--model", "hpe_wipose", "--synthetic",
                            "--wipose_root", os.path.join(root, "w"),
                            "--output_dir", out, "--epochs", "1",
                            "--batch_size", "8", "--device", "cpu"]) == 0
with open(os.path.join(out, "robustness_hpe_wipose_mode0.json")) as fd:
    print("keys", sorted(json.load(fd)["0.0"]))
"""


def test_robustness_kit_imports_without_them():
    block = f"for name in {BLOCKED!r}:"
    r = _run(["-c", _IMPORT_ALL.replace(
        block, f"for name in {BLOCKED + KIT_BLOCKED!r}:", 1)])
    assert r.returncode == 0, r.stdout + r.stderr
    for module in KIT_MODULES:
        assert f"wiflow_tpu_torch.{module}" in r.stdout.split(), module


def test_robustness_cli_runs_without_them(tmp_path):
    r = _run(["-c", _KIT_CLI_WITHOUT_THEM.format(
        blocked=BLOCKED + KIT_BLOCKED), str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines()[-1] == (
        "keys ['sweep', 'test_mpjpe', 'test_pck20', 'test_pck50']")


def test_robustness_entry_points_need_cuda_or_an_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from wiflow_tpu_torch.cli import robustness_demo, run_robustness
    from wiflow_tpu_torch.models.baselines import hpeli_zoo, sknet_trans
    from wiflow_tpu_torch.robustness import (
        DenoiserHPE, StackedDenoisingAE, evaluate_robustness,
        train_denoiser_stage,
    )
    x = np.zeros((4, 3, 8, 4), np.float32)
    for make in (hpeli_zoo.OriginalHPE, hpeli_zoo.BasicCnnHPE,
                 hpeli_zoo.HPEWiPoseModel, hpeli_zoo.DSKNetTransMMFi,
                 hpeli_zoo.DSKNetTransWipose, sknet_trans.DSKNetTrans,
                 DenoiserHPE, StackedDenoisingAE,
                 lambda: train_denoiser_stage(x, 1, lambda c, g: c),
                 lambda: evaluate_robustness(lambda b: b, x, x)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for main in (run_robustness.main, robustness_demo.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--epochs", "1", "--output_dir", str(tmp_path / "out"),
                  "--dataset_root", str(tmp_path / "mmfi")])
    assert not os.path.exists(tmp_path / "mmfi")


# The last modules: data parallelism and the demo CLIs import nothing the
# card's machine lacks, and no JAX.
LAST_MODULES = ("parallel", "parallel.mesh", "cli.convergence_demo",
                "cli.kill_resume_demo", "cli.loso_demo")


def test_parallel_and_demo_modules_import_without_them():
    block = f"for name in {BLOCKED!r}:"
    r = _run(["-c", _IMPORT_ALL.replace(
        block, f"for name in {BLOCKED + KIT_BLOCKED!r}:", 1)])
    assert r.returncode == 0, r.stdout + r.stderr
    for module in LAST_MODULES:
        assert f"wiflow_tpu_torch.{module}" in r.stdout.split(), module


def test_demo_entry_points_need_cuda_or_an_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from wiflow_tpu_torch.cli import convergence_demo, loso_demo
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convergence_demo.main(["--windows", "20", "--output_dir",
                               str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loso_demo.main(["--per_subject", "8", "--subjects", "2",
                        "--output_dir", str(tmp_path / "l")])
