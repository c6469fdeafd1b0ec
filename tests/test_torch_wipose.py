"""The port's WiPose data layer == the JAX package's (both host numpy).

``wiflow_tpu_torch/data/wipose.py`` against ``wiflow_tpu/data/wipose.py``:
the synthetic tree byte for byte from one seed, ``materialize`` and
``compute_stats`` equal, normalisation by given statistics, and the
``.mat`` loader on HDF5 files the test writes (``mat73`` is not installed
here, so both packages read them through ``h5py``, imported when called).
"""

import os

import numpy as np
import pytest

from wiflow_tpu.data import wipose as jax_wipose

from wiflow_tpu_torch.data import wipose


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as fd:
                out[os.path.relpath(p, root)] = fd.read()
    return out


@pytest.mark.parametrize("per_split,seed", [(8, 0), (5, 3)])
def test_synthetic_tree_is_byte_equal(tmp_path, per_split, seed):
    a = wipose.generate_synthetic_wipose(str(tmp_path / "port"), per_split,
                                         seed)
    b = jax_wipose.generate_synthetic_wipose(str(tmp_path / "jax"),
                                             per_split, seed)
    fa, fb = _files(a), _files(b)
    assert len(fa) == 2 * 2 * per_split
    assert fa == fb


def test_materialize_and_stats_equal(tmp_path):
    root = wipose.generate_synthetic_wipose(str(tmp_path / "w"), 6, 1)
    for split in ("Train", "Test"):
        ds, ref = (wipose.WiPoseDataset(root, split),
                   jax_wipose.WiPoseDataset(root, split))
        assert len(ds) == len(ref) == 6
        csi, kp = ds.materialize()
        rcsi, rkp = ref.materialize()
        assert csi.shape == (6, 9, 30, 5) and kp.shape == (6, 18, 3)
        np.testing.assert_array_equal(csi, rcsi)
        np.testing.assert_array_equal(kp, rkp)
        mean, std = wipose.WiPoseDataset.compute_stats(csi)
        rmean, rstd = jax_wipose.WiPoseDataset.compute_stats(rcsi)
        np.testing.assert_array_equal(mean, rmean)
        np.testing.assert_array_equal(std, rstd)
        normed = wipose.WiPoseDataset(root, split, mean, std).materialize()
        rnormed = jax_wipose.WiPoseDataset(root, split, mean,
                                           std).materialize()
        np.testing.assert_array_equal(normed[0], rnormed[0])
        assert abs(normed[0].mean()) < 1e-5


def test_mat_files_through_h5py(tmp_path):
    """Two ``.mat`` (HDF5) samples beside an ``.npy`` pair: the ``.mat``
    files come first, in name order, read as the JAX package reads them."""
    h5py = pytest.importorskip("h5py")
    d = tmp_path / "w" / "Train"
    d.mkdir(parents=True)
    rng = np.random.default_rng(2)
    for i, shape in enumerate(((5, 30, 3, 3), (9, 30, 5))):
        with h5py.File(d / f"m{i}.mat", "w") as f:
            f["CSI"] = rng.standard_normal(shape).astype(np.float32)
            f["SkeletonPoints"] = rng.standard_normal((18, 3)).astype(
                np.float32) * 1000
    np.save(d / "s0000_csi.npy", rng.standard_normal((9, 30, 5)).astype(
        np.float32))
    np.save(d / "s0000_kp.npy", np.ones((18, 3), np.float32))
    for i in range(2):
        got = wipose.load_wipose_mat(str(d / f"m{i}.mat"))
        ref = jax_wipose.load_wipose_mat(str(d / f"m{i}.mat"))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        assert got[0].shape == (9, 30, 5) and got[1].shape == (18, 3)
    root = str(tmp_path / "w")
    csi, kp = wipose.WiPoseDataset(root, "Train").materialize()
    rcsi, rkp = jax_wipose.WiPoseDataset(root, "Train").materialize()
    np.testing.assert_array_equal(csi, rcsi)
    np.testing.assert_array_equal(kp, rkp)
    assert len(csi) == 3 and np.all(kp[2] == 1.0)
