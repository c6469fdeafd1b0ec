"""The port's data pipeline == the JAX package's, on the CPU.

On one raw directory from ``generate_raw_dataset`` (6 files x 40 frames):
the synthetic raw files byte for byte, the ``preprocess_csi_data``
artifacts array for array, the keypoint CSV reader (csv module) against
the JAX one (pandas), ``materialize`` in npy and CSV mode, and the splits
index for index over several file counts and seeds.  Every comparison is
exact: the same numpy and Python arithmetic on both sides.
"""

import os
import pickle

import numpy as np
import pytest

from wiflow_tpu.data import dataset as jax_dataset
from wiflow_tpu.data import preprocess as jax_pre
from wiflow_tpu.data import splits as jax_splits
from wiflow_tpu.data import synthetic as jax_synth

from wiflow_tpu_torch.data import dataset, preprocess, splits, synthetic

FILES, FRAMES = 6, 40
ARTIFACTS = ("csi_windows.npy", "window_info.npz", "file_info.npz",
             "config.npz", "all_keypoints.npy", "file_mappings.pkl")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    jax_synth.generate_raw_dataset(str(root / "jax"), num_files=FILES,
                                   frames_per_file=FRAMES, seed=3)
    synthetic.generate_raw_dataset(str(root / "port"), num_files=FILES,
                                   frames_per_file=FRAMES, seed=3)
    return root


@pytest.fixture(scope="module")
def artifacts(raw):
    """Both packages' artifacts of the JAX raw directory."""
    out = {}
    for name, mod in (("jax", jax_pre), ("port", preprocess)):
        out[name] = str(raw / f"pre_{name}")
        mod.preprocess_csi_data(str(raw / "jax"), out[name])
    return out


def _load(path):
    if path.endswith(".npy"):
        return {"": np.load(path)}
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    with open(path, "rb") as f:
        return pickle.load(f)


def test_synthetic_raw_files_are_byte_equal(raw):
    names = sorted(os.listdir(raw / "jax"))
    assert names == sorted(os.listdir(raw / "port"))
    assert len(names) == 2 * FILES
    for name in names:
        assert (raw / "jax" / name).read_bytes() == \
            (raw / "port" / name).read_bytes(), name


def test_preprocess_artifacts_are_equal(raw, artifacts):
    for name in ARTIFACTS:
        ref = _load(os.path.join(artifacts["jax"], name))
        got = _load(os.path.join(artifacts["port"], name))
        assert sorted(got) == sorted(ref), name
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                assert got[k].dtype == ref[k].dtype, (name, k)
                np.testing.assert_array_equal(got[k], ref[k], err_msg=name)
            else:
                assert got[k] == ref[k], (name, k)
    stats = preprocess.preprocess_csi_data(str(raw / "jax"),
                                           str(raw / "again"), stride=3)
    assert stats == jax_pre.preprocess_csi_data(str(raw / "jax"),
                                                str(raw / "again_jax"),
                                                stride=3)


def test_keypoint_csv_reader_equals_pandas(raw, tmp_path):
    paths = [str(raw / "jax" / n) for n in sorted(os.listdir(raw / "jax"))
             if n.endswith(".csv")]
    # a CSV with leading columns, an empty field and a blank line
    rng = np.random.default_rng(0)
    vals = rng.uniform(0, 2000, (5, 50))
    lines = ["frame,name," + ",".join(f"c{j}" for j in range(50))]
    for i, row in enumerate(vals):
        cells = [repr(float(v)) for v in row]
        if i == 2:
            cells[7] = ""
        lines.append(f"{i},f{i}," + ",".join(cells))
    extra = tmp_path / "extra_keypoints.csv"
    extra.write_text("\n".join(lines[:3]) + "\n\n" + "\n".join(lines[3:])
                     + "\n")
    for path in paths + [str(extra)]:
        for scale in (1000.0, 1.0):
            got = preprocess.load_keypoints_csv(path, scale)
            ref = jax_pre.load_keypoints_csv(path, scale)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref, err_msg=path)
    assert np.isnan(preprocess.load_keypoints_csv(str(extra))).sum() == 1


@pytest.mark.parametrize("csv_mode", [False, True], ids=["npy", "csv"])
def test_materialize_equals_jax(artifacts, csv_mode, tmp_path):
    d = artifacts["port"]
    if csv_mode:
        d = str(tmp_path / "csv")
        os.makedirs(d)
        for name in ARTIFACTS[:4]:
            with open(os.path.join(artifacts["port"], name), "rb") as f, \
                    open(os.path.join(d, name), "wb") as g:
                g.write(f.read())
    got, ref = dataset.CSIKeypointsDataset(d), \
        jax_dataset.CSIKeypointsDataset(d)
    assert got.use_npy_mode == ref.use_npy_mode == (not csv_mode)
    assert len(got) == len(ref) and got.file_ids == ref.file_ids
    idx = np.random.default_rng(1).permutation(len(ref))[:50]
    for sel in (None, idx):
        for a, b in zip(got.materialize(sel), ref.materialize(sel)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.get_samples_from_file(2),
                                  ref.get_samples_from_file(2))


@pytest.mark.parametrize("num_files", [1, 3, 8, 20, 57])
@pytest.mark.parametrize("seed", [0, 42, 7])
def test_splits_equal_jax_index_for_index(num_files, seed):
    assert splits.file_level_split(num_files, seed=seed) == \
        jax_splits.file_level_split(num_files, seed=seed)
    assert splits.file_level_split(num_files, 0.6, 0.2, seed) == \
        jax_splits.file_level_split(num_files, 0.6, 0.2, seed)
    subjects = [i % 5 + 1 for i in range(num_files)]
    for test_subject in sorted(set(subjects))[:2]:
        if num_files > 1:
            assert splits.loso_split(subjects, test_subject, seed=seed) == \
                jax_splits.loso_split(subjects, test_subject, seed=seed)
    ranges = np.cumsum(np.arange(1, num_files + 1))
    ranges = np.stack([np.r_[0, ranges[:-1]], ranges], 1)
    files = splits.file_level_split(num_files, seed=seed)[0]
    np.testing.assert_array_equal(
        splits.expand_to_samples(ranges, files),
        jax_splits.expand_to_samples(ranges, files))


def test_subjects_windows_and_zero_repair_equal_jax():
    for fid in ("subject3_walk_01", "user_2/x", "s05-run", "P_s12"):
        assert splits.infer_subject(fid) == jax_splits.infer_subject(fid)
    for fid in ("files3", "walk"):
        with pytest.raises(ValueError):
            splits.infer_subject(fid)
    rng = np.random.default_rng(2)
    csi = rng.standard_normal((33, 12)).astype(np.float32)
    for w, s in ((20, 1), (5, 3), (40, 1)):
        assert preprocess.window_count(33, w, s) == \
            jax_pre.window_count(33, w, s)
        np.testing.assert_array_equal(preprocess.window_csi(csi, w, s),
                                      jax_pre.window_csi(csi, w, s))
    kp = rng.standard_normal((30, 15, 2)).astype(np.float32)
    kp[rng.random((30, 15)) < 0.2] = 0.0
    kp[4] = 0.0
    np.testing.assert_array_equal(preprocess.clean_single_frame_zeros(kp),
                                  jax_pre.clean_single_frame_zeros(kp))
    np.testing.assert_array_equal(
        preprocess.clean_zero_keypoints_temporal(kp),
        jax_pre.clean_zero_keypoints_temporal(kp))
