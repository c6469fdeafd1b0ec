"""The port's CLIs on the CPU, against the JAX package's.

``cli.run.main`` on a pre-made 8-file dataset (8 x 40 frames: 5/1/2
files, so the val split is not empty) at the default model width in fp32,
for 1 epoch and then a resume to 2: it writes every file of the README's
"Training outputs" but the videos, the resumed history repeats the first
epoch exactly, and the test split is the JAX CLI's, window for window
(the targets of ``test_predictions.csv`` against the JAX dataset's
targets of the JAX split, staged in fp32 and scaled by 1000: equal).  The
parsers take the JAX CLIs' flags with the same defaults, plus
``--device``; ``cli.preprocess`` writes the JAX CLI's artifacts.
"""

import csv
import os

import numpy as np
import pytest
import torch

from wiflow_tpu.cli import preprocess as jax_preprocess_cli
from wiflow_tpu.cli import run as jax_run
from wiflow_tpu.data import dataset as jax_dataset
from wiflow_tpu.data import splits as jax_splits
from wiflow_tpu.data import synthetic as jax_synth

from wiflow_tpu_torch.cli import preprocess as preprocess_cli
from wiflow_tpu_torch.cli import run
from wiflow_tpu_torch.core.checkpoint import load_best_model, load_checkpoint

OUTPUTS = ("best_pose_model.msgpack", "best_pose_model.pth",
           "latest_checkpoint.pkl", "training_history.csv",
           "training_history.png", "test_predictions.csv",
           "keypoint_error_stats.csv", "test_results_summary.csv")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pool in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return jax_synth.make_preprocessed_dataset(str(root), num_files=8,
                                               frames_per_file=40)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_train_resume_and_outputs(data_dir, tmp_path, capsys):
    out = str(tmp_path / "out")
    args = ["--data_dir", data_dir, "--output_dir", out, "--device", "cpu",
            "--compute_dtype", "float32", "--no_videos", "--batch_size",
            "16", "--use_augmentation"]
    assert run.main(args + ["--epochs", "1"]) == 0
    first = _rows(os.path.join(out, "training_history.csv"))
    assert len(first) == 2
    assert run.main(args + ["--epochs", "2"]) == 0
    log = capsys.readouterr().out
    assert "[resume] continuing from epoch 2 of 2" in log
    assert "Epoch 2/2" in log and "[split] train: 105 samples" in log
    assert sorted(os.listdir(out)) == sorted(OUTPUTS)
    hist = _rows(os.path.join(out, "training_history.csv"))
    assert len(hist) == 3 and hist[:2] == first
    assert load_checkpoint(os.path.join(out, "latest_checkpoint.pkl"))[
        "epoch"] == 1

    # the test split is the JAX CLI's: file_level_split(8, seed 42) and
    # its windows in order, eval batches of 8 with drop_last
    ds = jax_dataset.CSIKeypointsDataset(data_dir)
    test_files = jax_splits.file_level_split(ds.num_files, seed=42)[2]
    _, y = ds.materialize(jax_splits.expand_to_samples(ds.window_ranges,
                                                       test_files))
    rows = _rows(os.path.join(out, "test_predictions.csv"))
    n = len(y) // 8 * 8
    assert len(rows) == n + 1
    true_cols = [i for i, h in enumerate(rows[0]) if h.startswith("true_")]
    got = np.array([[float(r[i]) for i in true_cols] for r in rows[1:]],
                   np.float32)
    # labels are staged in fp32, then scaled
    np.testing.assert_array_equal(
        got, (y[:n].astype(np.float32) * 1000.0).reshape(n, -1))

    pth = load_best_model(os.path.join(out, "best_pose_model.pth"))
    msg = load_best_model(os.path.join(out, "best_pose_model.msgpack"))
    for k, t in msg.items():
        assert torch.equal(t, pth[k]), k


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_flags_match_the_jax_clis():
    ours = _options(run.build_parser())
    ref = _options(jax_run.build_parser())
    assert ours.pop("device") == (("--device",), "cuda", ["cuda", "cpu"])
    assert ours == ref
    assert _options(preprocess_cli.build_parser()) == \
        _options(jax_preprocess_cli.build_parser())


def test_refusals(data_dir, tmp_path, capsys):
    with pytest.raises(SystemExit, match="multi-GPU"):
        run.main(["--gpu", "2", "--device", "cpu"])
    assert run.main(["--data_dir", str(tmp_path / "none"), "--device",
                     "cpu"]) == 2
    assert "no preprocessed artifacts" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run.main(["--data_dir", data_dir])


def test_preprocess_cli_writes_the_jax_artifacts(data_dir, tmp_path):
    raw = os.path.join(os.path.dirname(data_dir), "raw")
    assert preprocess_cli.main(["--raw_dir", raw, "--output_dir",
                                str(tmp_path / "port"), "--stride",
                                "2"]) == 0
    assert jax_preprocess_cli.main(["--raw_dir", raw, "--output_dir",
                                    str(tmp_path / "jax"), "--stride",
                                    "2"]) == 0
    for name in ("csi_windows.npy", "all_keypoints.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))
    for name in ("window_info.npz", "file_info.npz", "config.npz"):
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
