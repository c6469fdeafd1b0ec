"""The port's result artifacts and metrics against the JAX package's.

``write_all_artifacts`` runs on the same predictions, targets, test
metrics and history in both packages: every CSV has the same header and
index column, and values equal to 1e-6 relative (``CSV_TOL``; they are the
same numbers, formatted as pandas formats them, except the per-joint PCK,
which each side computes in fp32).  ``calculate_pck``, ``pck_per_keypoint``
(the 15-, 17- and 18-keypoint normalizers) and ``calculate_mpjpe`` equal
the JAX functions to 1e-6 (``METRIC_TOL``).  Without matplotlib or OpenCV
the port prints one line naming the files it skipped and writes the rest.
"""

import csv
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.eval import artifacts as jax_artifacts
from wiflow_tpu.metrics import metrics as jax_metrics

from wiflow_tpu_torch.eval import artifacts
from wiflow_tpu_torch.metrics import metrics
from wiflow_tpu_torch.train.loop import HISTORY_KEYS

CSV_TOL = METRIC_TOL = 1e-6
CSVS = ("test_predictions.csv", "keypoint_error_stats.csv",
        "test_results_summary.csv", "training_history.csv")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pool in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _result(seed=0, n=1100, k=15, d=2, epochs=4):
    rng = np.random.default_rng(seed)
    targets = rng.uniform(0.1, 0.9, (n, k, d)).astype(np.float32)
    preds = (targets + 0.03 * rng.standard_normal(targets.shape)
             ).astype(np.float32)
    history = {key: [float(v) for v in rng.random(epochs)]
               for key in HISTORY_KEYS}
    test = {"loss": 0.01, "mpe": 0.04,
            **{f"pck@{t}": float(rng.random())
               for t in (0.1, 0.2, 0.3, 0.4, 0.5)}}
    return types.SimpleNamespace(predictions=preds, targets=targets,
                                 history=history, test_metrics=test)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("k", [15, 17])
def test_csvs_equal_jax(tmp_path, k):
    res = _result(k=k, d=2 if k == 15 else 3)
    names = None if k == 15 else {i: f"j{i}" for i in range(k)}
    jax_artifacts.write_all_artifacts(res, str(tmp_path / "jax"),
                                      make_videos=False,
                                      keypoint_names=names)
    paths = artifacts.write_all_artifacts(res, str(tmp_path / "port"),
                                          make_videos=False,
                                          keypoint_names=names)
    assert os.path.exists(paths["history_png"])
    for name in CSVS:
        ref, got = _read(tmp_path / "jax" / name), \
            _read(tmp_path / "port" / name)
        assert got[0] == ref[0], name                     # header
        assert len(got) == len(ref), name
        for r_row, g_row in zip(ref[1:], got[1:]):
            assert g_row[0] == r_row[0], name             # index column
            for a, b in zip(g_row, r_row):
                try:
                    ref_v = float(b)
                except ValueError:
                    assert a == b, name
                    continue
                assert abs(float(a) - ref_v) <= CSV_TOL * max(1.0,
                                                              abs(ref_v)), \
                    (name, a, b)


def test_missing_matplotlib_and_opencv_skip_with_a_line(tmp_path, capsys,
                                                        monkeypatch):
    for mod in ("matplotlib", "matplotlib.pyplot", "cv2"):
        monkeypatch.setitem(sys.modules, mod, None)
    paths = artifacts.write_all_artifacts(_result(n=30), str(tmp_path))
    out = capsys.readouterr().out
    assert "skipped training_history.png" in out
    assert "skipped videos/true_poses.mp4" in out
    assert sorted(os.listdir(tmp_path)) == sorted(CSVS)
    assert set(paths) == {"predictions", "error_stats", "summary",
                          "history_csv"}


def test_videos_where_opencv_is_present(tmp_path):
    pytest.importorskip("cv2")
    paths = artifacts.write_all_artifacts(_result(n=30), str(tmp_path),
                                          max_video_frames=4)
    for kind in ("video_true", "video_pred", "video_comparison"):
        assert os.path.getsize(paths[kind]) > 0, kind


@pytest.mark.parametrize("k,a,b,clamp,ref_fn", [
    (15, 2, 12, 1e-6, jax_metrics.compute_pck_pckh_15),
    (17, 5, 12, None, jax_metrics.compute_pck_pckh),
    (18, 6, 13, None, jax_metrics.compute_pck_pckh_18),
])
def test_metrics_equal_jax(k, a, b, clamp, ref_fn):
    rng = np.random.default_rng(k)
    t = rng.uniform(-1, 1, (40, k, 2)).astype(np.float32)
    p = (t + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)
    t[3, b] = t[3, a]                      # a zero normalizer
    for thr in (0.2, 0.5):
        got = metrics.pck_per_keypoint(torch.from_numpy(p),
                                       torch.from_numpy(t), thr, a, b, clamp)
        ref = ref_fn(p, t, thr)
        finite = np.isfinite(ref)
        assert (np.isfinite(got.numpy()) == finite).all()
        assert np.abs(got.numpy()[finite] - ref[finite]).max() <= \
            METRIC_TOL * 100
    if k == 15:
        thr = (0.1, 0.2, 0.5)
        got = metrics.calculate_pck(p, t, thr)
        ref = jax_metrics.calculate_pck(jnp.asarray(p), jnp.asarray(t), thr)
        assert got.keys() == ref.keys()
        assert all(abs(got[x] - ref[x]) <= METRIC_TOL for x in thr)
        assert abs(metrics.calculate_mpjpe(p, t)
                   - jax_metrics.calculate_mpjpe(jnp.asarray(p),
                                                 jnp.asarray(t))) <= \
            METRIC_TOL * jax_metrics.calculate_mpjpe(p, t)
