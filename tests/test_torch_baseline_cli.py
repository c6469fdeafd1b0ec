"""The port's baseline and ablation CLIs on the CPU, against the JAX
package's.

* ``cli.run_baseline --device cpu --synthetic`` for each of the four
  baselines, 1 epoch and then a resume to 2, on a pre-made 8-file dataset:
  the PAM notice for the PAM models, the resume, the files (a baseline
  has no reference torch names: ``.msgpack`` only, as the JAX CLI writes).
* ``cli.run_mmfi --model`` each baseline on a tree of the ``--synthetic``
  subjects and actions at 16 frames, 1 epoch.
* ``cli.baseline_table`` over two models, then a rerun of one (the other's
  row is kept), with a FLOPs cell in every row; ``cli.ablation_demo`` over
  two variants, then a rerun that resumes.
* The parsers take the JAX CLIs' flags with the same defaults, plus
  ``--device``; ``--max_steps_per_call`` other than 0 is refused.
* ``utils/flops.py`` against the JAX package's ``jaxpr_flops``.

HPE-Li runs at its published size.  WiSPPN's stem is a 600-channel (1140
on MM-Fi) 3x3 conv on a 120x120 map, about 0.1 TFLOP a window, and
PerUnet's and WPformer's published trunks are not much lighter: on the CPU
the CLIs get them at small widths (the JAX tests' configurations), and
the ``wisppn`` recipe a small PerUnet with the same PAM output in WiSPPN's
place.  The models themselves are held to the JAX package in
``tests/test_torch_baselines.py``; at their published widths they run
through these CLIs on the card (``chip_smoke.py`` phase 17).
"""

import argparse
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.cli import ablation_demo as jax_ablation_demo
from wiflow_tpu.cli import baseline_table as jax_baseline_table
from wiflow_tpu.cli import run_baseline as jax_run_baseline
from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models import baselines as jb
from wiflow_tpu.models.wiflow import WiFlowPoseModel as JaxWiFlow
from wiflow_tpu.utils.flops import jaxpr_flops

from tests.test_torch_cli import _options, _rows
from wiflow_tpu_torch.cli import (
    ablation_demo, baseline_table, run_baseline, run_mmfi,
)
from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.data.mmfi import generate_synthetic_mmfi
from wiflow_tpu_torch.data.synthetic import make_preprocessed_dataset
from wiflow_tpu_torch.models import baselines as pb
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.utils.flops import (
    count_params, flop_count, profile_model, resize_flops,
)

SMALL_MODELS = {
    "wisppn": functools.partial(pb.PerUnet, base=8),
    "perunet": functools.partial(pb.PerUnet, base=8),
    "wpformer": functools.partial(pb.WPformer, num_chunks=18,
                                  resize_to=(30, 20), trunk_widths=(8, 16),
                                  trunk_blocks=(1, 1)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("baselines")
    return make_preprocessed_dataset(str(root), num_files=8,
                                     frames_per_file=24)


@pytest.fixture(scope="module")
def mmfi_root(tmp_path_factory):
    """The ``--synthetic`` tree's subjects and actions at 16 frames."""
    root = str(tmp_path_factory.mktemp("mmfi") / "MMFi")
    generate_synthetic_mmfi(root, subjects=("S01", "S02", "S11"),
                            actions=("A01", "A02"), frames=16)
    return root


def _jax_parser(main, monkeypatch):
    """The parser a JAX ``main`` builds inside itself."""
    class Got(Exception):
        pass

    def grab(self, *a, **k):
        raise Got(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Got) as e:
        main([])
    monkeypatch.undo()
    return e.value.args[0]


def test_flags_match_the_jax_clis(monkeypatch):
    for ours, ref in (
            (run_baseline.build_parser(), jax_run_baseline.build_parser()),
            (baseline_table.build_parser(),
             _jax_parser(jax_baseline_table.main, monkeypatch)),
            (ablation_demo.build_parser(),
             _jax_parser(jax_ablation_demo.main, monkeypatch))):
        o, r = _options(ours), _options(ref)
        assert o.pop("device") == (("--device",), "cuda", ["cuda", "cpu"])
        assert o == r
    assert run_baseline.BASELINE_SPECS == jax_run_baseline.BASELINE_SPECS
    assert baseline_table.MODELS == jax_baseline_table.MODELS
    assert ablation_demo.VARIANTS == jax_ablation_demo.VARIANTS


@pytest.mark.parametrize("model", ["hpeli", "wisppn", "perunet", "wpformer"])
def test_run_baseline_trains_and_resumes(model, data_dir, tmp_path, capsys,
                                         monkeypatch):
    if model in SMALL_MODELS:
        monkeypatch.setitem(run_baseline._MODELS, model, SMALL_MODELS[model])
    out = str(tmp_path / "out")
    args = ["--model", model, "--synthetic", "--data_dir", data_dir,
            "--output_dir", out, "--device", "cpu", "--compute_dtype",
            "float32", "--batch_size", "8"]
    assert run_baseline.main(args + ["--epochs", "1"]) == 0
    log = capsys.readouterr().out
    assert ("NOTICE: no --pam_root given" in log) == (model != "hpeli")
    assert "[done]" in log
    first = _rows(os.path.join(out, "training_history.csv"))
    assert run_baseline.main(args + ["--epochs", "2"]) == 0
    log = capsys.readouterr().out
    assert "[resume] continuing from epoch 2 of 2" in log
    hist = _rows(os.path.join(out, "training_history.csv"))
    assert len(hist) == 3 and hist[:2] == first
    files = set(os.listdir(out))
    assert {"best_pose_model.msgpack", "latest_checkpoint.pkl",
            "test_predictions.csv", "test_results_summary.csv"} <= files
    assert "best_pose_model.pth" not in files


@pytest.mark.parametrize("model", ["hpeli", "wisppn", "perunet", "wpformer"])
def test_run_mmfi_trains_each_baseline(model, mmfi_root, tmp_path, capsys,
                                       monkeypatch):
    small = {
        "wisppn": ("WiSPPN", functools.partial(pb.PerUnet, base=8)),
        "perunet": ("PerUnetMMFi", functools.partial(pb.PerUnetMMFi,
                                                     base=8)),
        # 136 rows halved three times: the 17 keypoints, as published
        "wpformer": ("wpformer_mmfi", lambda dt, **kw: pb.WPformer(
            num_chunks=3, resize_to=(136, 16), num_keypoints=17,
            keypoint_dims=3, trunk_widths=(8, 8, 8, 8),
            trunk_blocks=(1, 1, 1, 1), input_mode="mmfi", compute_dtype=dt,
            **kw)),
    }
    if model in small:
        monkeypatch.setattr(run_mmfi, *small[model])
    out = str(tmp_path / "out")
    assert run_mmfi.main(["--model", model, "--synthetic", "--dataset_root",
                          mmfi_root, "--output_dir", out,
                          "--epochs", "1", "--device", "cpu",
                          "--compute_dtype", "float32", "--no_videos",
                          "--batch_size", "16"]) == 0
    log = capsys.readouterr().out
    assert "[done] best epoch 1" in log
    rows = _rows(os.path.join(out, "test_predictions.csv"))
    # hpeli scores the 2-D projection, the others the 3-D keypoints
    assert len(rows[0]) == 17 * (2 if model == "hpeli" else 3) * 2 + 1


def test_run_mmfi_masked_mse():
    y = torch.tensor([[[1.0, 2.0, 0.5], [0.0, 0.0, 0.0]]])
    out = torch.tensor([[[1.5, 2.0, 0.5], [3.0, 3.0, 3.0]]])
    loss, parts = run_mmfi.metafi_masked_mse(out, y)
    assert float(loss) == pytest.approx(0.25 / 6)
    assert float(parts["bone"]) == 0.0


def test_baseline_table_writes_and_merges(tmp_path, capsys):
    out = str(tmp_path / "table")
    args = ["--windows", "60", "--epochs", "1", "--batch_size", "8",
            "--output_dir", out, "--device", "cpu", "--compute_dtype",
            "float32"]
    assert baseline_table.main(args + ["--models", "wiflow,hpeli"]) == 0
    with open(os.path.join(out, "comparison_summary.json")) as fd:
        summary = json.load(fd)
    rows = {r["model"]: r for r in summary["rows"]}
    assert list(rows) == ["wiflow", "hpeli"]
    assert summary["device"] == "cpu"
    for r in rows.values():
        assert r["flops_g"] > 0 and "FlopCounterMode" in r["flops_note"]
        assert r["step_ms"] > 0 and r["windows_per_s"] > 0
        assert r["peak_mem_gb"] is None
    assert rows["hpeli"]["params_m"] == 0.83
    assert rows["hpeli"]["flops_g"] == round(2153049600 / 1e9, 3)
    first = rows["wiflow"]
    assert baseline_table.main(args + ["--models", "hpeli",
                                       "--per_model_batch", "hpeli=4"]) == 0
    with open(os.path.join(out, "comparison_summary.json")) as fd:
        rows = {r["model"]: r for r in json.load(fd)["rows"]}
    assert rows["wiflow"] == first and rows["hpeli"]["batch_size"] == 4
    with open(os.path.join(out, "comparison_table.md")) as fd:
        table = fd.read()
    assert "| wiflow |" in table and "| hpeli |" in table
    with pytest.raises(SystemExit, match="TPU matter"):
        baseline_table.main(args + ["--max_steps_per_call", "8"])
    with pytest.raises(SystemExit, match="unknown"):
        baseline_table.main(args + ["--models", "wiflow,resnet"])


def test_ablation_demo_writes_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "abl")
    args = ["--windows", "60", "--epochs", "1", "--batch_size", "8",
            "--output_dir", out, "--device", "cpu", "--compute_dtype",
            "float32", "--variants", "full,no_attention"]
    assert ablation_demo.main(args) == 0
    with open(os.path.join(out, "ablation_summary.json")) as fd:
        summary = json.load(fd)
    rows = {r["variant"]: r for r in summary["rows"]}
    assert list(rows) == ["full", "no_attention"]
    assert rows["full"]["params"] == count_params(
        WiFlowPoseModel(ModelConfig(), device="cpu"))
    assert rows["full"]["params"] - rows["no_attention"]["params"] == 25_632
    assert rows["full"]["step_ms"] > 0
    with open(os.path.join(out, "ablation_table.md")) as fd:
        assert fd.read().count("\n") == 4
    assert sorted(os.listdir(os.path.join(out, "full"))) == [
        "best_pose_model.msgpack", "best_pose_model.pth",
        "latest_checkpoint.pkl"]
    capsys.readouterr()
    assert ablation_demo.main(args[:-1] + ["conv2d_encoder,full"]) == 0
    log = capsys.readouterr().out
    assert "[resume] continuing from epoch 2 of 1" in log
    assert sorted(os.listdir(os.path.join(out, "conv2d_encoder"))) == [
        "best_pose_model.msgpack", "latest_checkpoint.pkl"]
    with pytest.raises(SystemExit, match="unknown"):
        ablation_demo.main(args[:-1] + ["full,tcn_dense"])


def _jax_flops(model, x):
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(0)}, jnp.asarray(x))
    return jaxpr_flops(lambda xx: model.apply(v, xx, train=False),
                       jnp.asarray(x))


def test_flop_count_matches_jaxpr_flops():
    x = np.zeros((2, 540, 20), np.float32)
    got = flop_count(pb.HPELiNet(compute_dtype="float32", device="cpu"),
                     torch.from_numpy(x))
    assert got == _jax_flops(jb.HPELiNet(compute_dtype="float32"), x)
    # WiFlow: the JAX taps lowering writes the input block's one-channel
    # convs (the (1,3) conv and the 1x1 shortcut, 1 -> 8 channels) as
    # broadcast multiplies, which jaxpr_flops does not count
    model = WiFlowPoseModel(ModelConfig(compute_dtype="float32"),
                            device="cpu")
    got = flop_count(model, torch.from_numpy(x))
    ref = _jax_flops(JaxWiFlow(JaxModelConfig(compute_dtype="float32")), x)
    assert got - ref == 2 * 2 * 20 * 240 * (3 + 1) * 8
    # a model that resizes: its resizes as the JAX package's products
    kw = dict(layers=(1, 1, 1, 1), widths=(32, 32, 64, 64),
              compute_dtype="float32")
    x1 = torch.zeros(1, 540, 20)
    wisppn = pb.WiSPPN(**kw, device="cpu")
    assert flop_count(wisppn, x1) + resize_flops(wisppn, x1) == _jax_flops(
        jb.WiSPPN(**kw), x1.numpy())
    prof = profile_model(pb.HPELiNet(compute_dtype="float32", device="cpu"),
                         torch.from_numpy(x))
    assert prof["params"] == count_params(pb.HPELiNet(device="cpu"))
    assert prof["gmacs_per_sample"] == prof["gflops_per_sample"] / 2
