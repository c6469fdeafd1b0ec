"""The port's demo CLIs on the CPU: ``convergence_demo``,
``kill_resume_demo`` and ``loso_demo``, each with ``--device cpu``.

The full-width model trains slowly on a CPU, so the runs are cut
in windows, epochs and batch, never in widths: 48-96 windows, 1-3 epochs,
batches of 8.  ``run_summary.json`` must carry the keys of the JAX
``convergence_demo.main``'s summary, read from its source (running the
JAX demo would train a JAX model).
"""

import ast
import json
import os

import pytest
import torch

from wiflow_tpu_torch.cli import convergence_demo, kill_resume_demo, loso_demo

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_summary_keys():
    """The keys of the dict the JAX ``main`` writes as run_summary.json."""
    import wiflow_tpu
    path = os.path.join(os.path.dirname(wiflow_tpu.__file__), "cli",
                        "convergence_demo.py")
    with open(path, encoding="utf-8") as fd:
        tree = ast.parse(fd.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "summary"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no summary dict in the JAX convergence demo")


def test_convergence_demo_writes_the_jax_summary(tmp_path, capsys):
    out = str(tmp_path / "conv")
    assert convergence_demo.main([
        "--windows", "48", "--epochs", "2", "--batch_size", "8",
        "--no_videos", "--output_dir", out, *CPU]) == 0
    text = capsys.readouterr().out
    assert "[data] 48 windows" in text and "Epoch 2/2" in text
    assert "[done] 2 epochs" in text
    with open(os.path.join(out, "run_summary.json"), encoding="utf-8") as fd:
        summary = json.load(fd)
    assert set(summary) == _jax_summary_keys()
    assert summary["windows"] == 48 and summary["epochs_run"] == 2
    assert len(summary["val_mpe_trajectory"]) == 2
    assert set(summary["test_metrics"]) == {
        "loss", "mpe", "pck@0.1", "pck@0.2", "pck@0.3", "pck@0.4", "pck@0.5"}
    for name in ("training_history.csv", "test_predictions.csv",
                 "keypoint_error_stats.csv", "test_results_summary.csv",
                 "best_pose_model.pth", "latest_checkpoint.pkl"):
        assert os.path.exists(os.path.join(out, name)), name
    assert not os.path.exists(os.path.join(out, "videos"))
    # the resume flag continues the run: nothing left to train at 2 epochs
    assert convergence_demo.main([
        "--windows", "48", "--epochs", "2", "--batch_size", "8",
        "--no_videos", "--resume", "--output_dir", out, *CPU]) == 0
    assert "[resume] continuing from epoch 3 of 2" in capsys.readouterr().out


def test_kill_resume_demo_resumes_mid_run(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the runs' threads
    out = str(tmp_path / "kr")
    assert kill_resume_demo.main([
        "--windows", "96", "--epochs", "3", "--kill_epoch", "1",
        "--batch_size", "8", "--output_dir", out, *CPU]) == 0
    with open(os.path.join(out, "kill_resume_summary.json"),
              encoding="utf-8") as fd:
        summary = json.load(fd)
    assert summary["run_b"]["killed_mid_epoch"] == 2
    assert "continuing from epoch 2 of 3" in summary["run_b"]["resume_line"]
    cmp_ = summary["history_compare"]
    assert cmp_["epochs_compared"] == 3 and cmp_["identical_within_tol"]
    # one process on the CPU repeats the run that was never stopped
    assert cmp_["max_abs_diff"] == 0.0
    assert "[kill] SIGKILL" in capsys.readouterr().out


def test_loso_demo_writes_its_summary_and_table(tmp_path):
    out = str(tmp_path / "loso")
    assert loso_demo.main([
        "--per_subject", "24", "--subjects", "3", "--epochs", "1",
        "--batch_size", "8", "--output_dir", out, *CPU]) == 0
    with open(os.path.join(out, "loso_summary.json"), encoding="utf-8") as fd:
        summary = json.load(fd)
    assert set(summary) == {"per_subject_windows", "epochs", "folds",
                            "average", "reference_table"}
    assert [r["subject"] for r in summary["folds"]] == [1, 2, 3]
    assert set(summary["folds"][0]) == {
        "subject", "pck20", "pck30", "pck50", "mpjpe_m", "epochs_run",
        "best_epoch", "wall_clock_min"}
    with open(os.path.join(out, "loso_table.md"), encoding="utf-8") as fd:
        table = fd.read().splitlines()
    assert table[0].startswith("| Test subject | PCK@20")
    assert [ln.split("|")[1].strip() for ln in table[2:]] == [
        "Subject 1", "Subject 2", "Subject 3", "**Average**"]
    for s in (1, 2, 3):
        assert os.path.exists(os.path.join(out, f"subject_{s}",
                                           "best_pose_model.pth"))
