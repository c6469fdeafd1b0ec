"""The port's robustness CLIs on the CPU: ``cli/run_robustness.py`` in its
three modes and on WiPose, and ``cli/robustness_demo.py``.

Each run writes ``robustness_<model>_mode<k>.json`` with the JAX CLI's keys
(the key tree of a JAX run of mode 2 on the same synthetic tree is the
template) and each run's ``training_history.csv`` with the JAX CLI's
columns; the demo its ``summary.json`` / ``summary.md`` table.  One intra-op
thread; narrow runs: 1 epoch, batch 8, the CLI's miniature MM-Fi tree.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from wiflow_tpu_torch.cli import robustness_demo, run_robustness

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(tree):
    """The key tree of a result: dicts by their keys, leaves as None."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def _header(path):
    with open(path, newline="", encoding="utf-8") as fd:
        return next(csv.reader(fd))


def _run(main, argv):
    assert main(argv) == 0


def _load(out, model, mode):
    with open(os.path.join(out, f"robustness_{model}_mode{mode}.json"),
              encoding="utf-8") as fd:
        return json.load(fd)


@pytest.fixture(scope="module")
def jax_template(tmp_path_factory):
    """A JAX run of mode 2 (basic_cnn, mean filter, level 0.2): its result's
    key tree and its history's columns."""
    from wiflow_tpu.cli.run_robustness import main
    tmp = tmp_path_factory.mktemp("jax")
    out = str(tmp / "out")
    _run(main, ["--model", "basic_cnn", "--mode", "2", "--epochs", "1",
                "--batch_size", "8", "--noise_levels", "0.2", "--filter",
                "mean", "--dataset_root", str(tmp / "mmfi"), "--output_dir",
                out, "--synthetic", "--no_resume", "--no_scan"])
    res = _load(out, "basic_cnn", 2)
    hist = _header(os.path.join(out, "basic_cnn_mode2_n0.2",
                                "training_history.csv"))
    return _keys(res["0.2"]), hist


def _check(out, model, mode, level, template, sweep_levels):
    keys, hist = template
    res = _load(out, model, mode)
    assert list(res) == [str(level)]
    row = res[str(level)]
    want = dict(keys, sweep={lv: keys["sweep"]["0.0"]
                             for lv in sweep_levels})
    assert _keys(row) == want
    assert 0.0 <= row["test_pck20"] <= 1.0
    assert np.isfinite(row["test_mpjpe"])
    assert _header(os.path.join(out, f"{model}_mode{mode}_n{level}",
                                "training_history.csv")) == hist
    return row


def test_mode0_basic_cnn(tmp_path, jax_template):
    out = str(tmp_path / "out")
    _run(run_robustness.main, [
        "--model", "basic_cnn", "--mode", "0", "--epochs", "1",
        "--batch_size", "8", "--dataset_root", str(tmp_path / "mmfi"),
        "--output_dir", out, "--synthetic", "--no_resume", "--no_scan",
        *CPU])
    _check(out, "basic_cnn", 0, 0.0, jax_template, ["0.0"])
    assert os.path.exists(os.path.join(out, "basic_cnn_mode0_n0.0",
                                       "best_pose_model.msgpack"))


def test_mode1_denoiser_one_stage_salt_pepper(tmp_path, jax_template):
    out = str(tmp_path / "out")
    _run(run_robustness.main, [
        "--model", "denoiser_hpe", "--denoiser_stages", "1",
        "--denoiser_epochs", "1", "--epochs", "1", "--batch_size", "8",
        "--noise_levels", "0.1", "--noise_kind", "salt_pepper",
        "--dataset_root", str(tmp_path / "mmfi"), "--output_dir", out,
        "--synthetic", "--no_resume", "--devices", "1", *CPU])
    _check(out, "denoiser_hpe", 1, 0.1, jax_template, ["0.0", "0.1"])


def test_mode2_mean_filter(tmp_path, jax_template):
    out = str(tmp_path / "out")
    _run(run_robustness.main, [
        "--model", "basic_cnn", "--mode", "2", "--epochs", "1",
        "--batch_size", "8", "--noise_levels", "0.2", "--filter", "mean",
        "--dataset_root", str(tmp_path / "mmfi"), "--output_dir", out,
        "--synthetic", "--no_resume", *CPU])
    _check(out, "basic_cnn", 2, 0.2, jax_template, ["0.0", "0.2"])


def test_hpe_wipose_on_the_synthetic_tree(tmp_path, jax_template):
    out = str(tmp_path / "out")
    _run(run_robustness.main, [
        "--model", "hpe_wipose", "--epochs", "1", "--batch_size", "8",
        "--wipose_root", str(tmp_path / "wipose"), "--output_dir", out,
        "--synthetic", "--no_resume", *CPU])
    row = _check(out, "hpe_wipose", 0, 0.0, jax_template, ["0.0"])
    assert np.isfinite(row["sweep"]["0.0"]["pa_mpjpe"])


def test_devices_other_than_one_are_refused(tmp_path):
    """More CUDA ranks than CUDA devices: nothing runs on fewer."""
    with pytest.raises(ValueError, match="more ranks than devices"):
        run_robustness.main(["--devices",
                             str(torch.cuda.device_count() + 2),
                             "--output_dir", str(tmp_path)])


def test_demo_one_epoch(tmp_path):
    out = str(tmp_path / "demo")
    _run(robustness_demo.main, [
        "--epochs", "1", "--levels", "0.1", "--denoiser_stages", "1",
        "--denoiser_epochs", "1", "--synthetic_frames", "48",
        "--work_dir", str(tmp_path / "work"), "--dataset_root",
        str(tmp_path / "mmfi"), "--output_dir", out, *CPU])
    with open(os.path.join(out, "summary.json"), encoding="utf-8") as fd:
        summary = json.load(fd)
    table = summary["table"]
    assert sorted(table) == ["clean", "levels"]
    assert sorted(table["levels"]["0.1"]) == ["denoiser", "filter", "none"]
    for row in (table["clean"], *table["levels"]["0.1"].values()):
        assert sorted(row) == ["mpjpe", "pck20", "pck50"]
        assert np.isfinite(row["mpjpe"])
    with open(os.path.join(out, "summary.md"), encoding="utf-8") as fd:
        md = fd.read()
    assert "| noise σ | defense | PCK@20 % | PCK@50 % | MPJPE |" in md
    assert len(md.strip().splitlines()) == 4 + 2 + 1 + 3
    for name in ("none", "filter", "denoiser"):
        assert os.path.exists(os.path.join(out, f"{name}_results.json"))
    # --collate_only rebuilds the same summary from the copied results
    _run(robustness_demo.main, ["--collate_only", "--levels", "0.1",
                                "--epochs", "1", "--denoiser_stages", "1",
                                "--denoiser_epochs", "1",
                                "--synthetic_frames", "48", "--work_dir",
                                str(tmp_path / "work"), "--dataset_root",
                                str(tmp_path / "mmfi"), "--output_dir", out,
                                *CPU])
    with open(os.path.join(out, "summary.json"), encoding="utf-8") as fd:
        assert json.load(fd)["table"] == table
