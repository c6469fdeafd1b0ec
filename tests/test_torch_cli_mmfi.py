"""The port's MM-Fi CLI on the CPU, against the JAX package's.

``cli.run_mmfi.main --synthetic`` writes the JAX CLI's miniature tree (S01,
S02, S11 x A01, A02 x 48 ``.mat`` frames), trains the default
``WiFlowMMFiModel`` in fp32 for 1 epoch and then resumes to 2: it writes
the best weights, the resume bundle, both ``.npz`` caches and the CSVs;
the resumed history repeats the first epoch exactly; the split is the
JAX CLI's (the targets of ``test_predictions.csv`` are the JAX dataset's
test frames, staged in fp32 and scaled by 1000: equal).  The parser takes
the JAX CLI's flags with the same defaults and choices, plus
``--device``; a missing root is refused, for every ``--model``.
"""

import csv
import os

import numpy as np
import pytest
import torch

from wiflow_tpu.cli import run_mmfi as jax_run_mmfi
from wiflow_tpu.data import mmfi as jax_mmfi

from tests.test_torch_cli import _options, _rows
from wiflow_tpu_torch.cli import run_mmfi
from wiflow_tpu_torch.core.checkpoint import load_best_model, load_checkpoint

OUTPUTS = ("best_pose_model.pth", "best_pose_model.msgpack",
           "latest_checkpoint.pkl", "mmfi_train_cache.npz",
           "mmfi_val_cache.npz", "training_history.csv",
           "test_predictions.csv", "keypoint_error_stats.csv",
           "test_results_summary.csv")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pool in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flags_match_the_jax_cli():
    ours = _options(run_mmfi.build_parser())
    ref = _options(jax_run_mmfi.build_parser())
    assert ours.pop("device") == (("--device",), "cuda", ["cuda", "cpu"])
    assert ours == ref
    assert run_mmfi.DEFAULT_CONFIG == jax_run_mmfi.DEFAULT_CONFIG


def test_synthetic_train_resume_and_outputs(tmp_path, capsys):
    root, out = str(tmp_path / "MMFi"), str(tmp_path / "out")
    args = ["--synthetic", "--dataset_root", root, "--output_dir", out,
            "--device", "cpu", "--compute_dtype", "float32", "--no_videos"]
    assert run_mmfi.main(args + ["--epochs", "1"]) == 0
    log = capsys.readouterr().out
    assert "[synthetic] generating miniature MM-Fi" in log
    assert "[split] train 144 / val 72 / test 72" in log
    first = _rows(os.path.join(out, "training_history.csv"))
    assert len(first) == 2
    assert run_mmfi.main(args + ["--epochs", "2"]) == 0
    log = capsys.readouterr().out
    assert "[synthetic]" not in log
    assert "[resume] continuing from epoch 2 of 2" in log and "[done]" in log
    assert set(OUTPUTS) <= set(os.listdir(out))
    hist = _rows(os.path.join(out, "training_history.csv"))
    assert len(hist) == 3 and hist[:2] == first
    bundle = load_checkpoint(os.path.join(out, "latest_checkpoint.pkl"))
    assert bundle["epoch"] == 1 and bundle["early_stopping"]["mode"] == "max"
    assert bundle["optimizer"]["param_groups"][0]["weight_decay"] == 1e-4

    # the JAX CLI's split of the JAX dataset: its test frames, in order
    _, val_ds = jax_mmfi.make_dataset(root, jax_run_mmfi.DEFAULT_CONFIG)
    _, kp = val_ds.materialize()
    _, ti = jax_mmfi.split_val_test(len(val_ds))
    y = kp[ti]
    rows = _rows(os.path.join(out, "test_predictions.csv"))
    n = len(y) // 32 * 32                  # eval batches of 64 // 2
    assert len(rows) == n + 1
    true_cols = [i for i, h in enumerate(rows[0]) if h.startswith("true_")]
    assert len(true_cols) == 17 * 3
    got = np.array([[float(r[i]) for i in true_cols] for r in rows[1:]],
                   np.float32)
    np.testing.assert_array_equal(
        got, (y[:n].astype(np.float32) * 1000.0).reshape(n, -1))
    with open(os.path.join(out, "keypoint_error_stats.csv"), newline="") as f:
        stats = list(csv.DictReader(f))
    assert len(stats) == 17 and all(r["pck@0.2"] for r in stats)
    pth = load_best_model(os.path.join(out, "best_pose_model.pth"))
    msg = load_best_model(os.path.join(out, "best_pose_model.msgpack"),
                          run_mmfi.MMFiModelConfig())
    assert sorted(msg) == sorted(k for k in pth
                                 if not k.endswith("num_batches_tracked"))
    for k, t in msg.items():
        assert torch.equal(t, pth[k]), k


@pytest.mark.parametrize("model", ["hpeli", "wisppn", "perunet", "wpformer"])
def test_baselines_are_refused(model, tmp_path, capsys):
    """A baseline trains since the baselines were ported
    (``tests/test_torch_baseline_cli.py``); like ``wiflow`` it is refused
    where the data root is missing, before a model is built."""
    assert run_mmfi.main(["--model", model, "--device", "cpu",
                          "--dataset_root", str(tmp_path / "none")]) == 2
    assert "not found" in capsys.readouterr().err


def test_missing_root_is_refused(tmp_path, capsys):
    assert run_mmfi.main(["--dataset_root", str(tmp_path / "none"),
                          "--device", "cpu"]) == 2
    assert "not found" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_mmfi.main(["--dataset_root", str(tmp_path)])
