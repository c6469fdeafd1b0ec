"""WiPose dataset support (the HPE-Li sub-project).

Counterpart of ``wiflow_tpu/data/wipose.py`` (ref cross_dataset_test/
HPE-Li/wipose/wipose_dataset.py:36-80), host numpy as there: per-sample
MATLAB v7.3 files holding ``CSI`` (reshaped to [9, 30, 5]) and
``SkeletonPoints`` ([3, 18] -> 18 keypoints, xy scaled by 0.001 with a
confidence column), per-channel mean/std normalization with the constants
the reference computed over the corpus.

``.npy`` sample files (dict-free: ``<stem>_csi.npy`` + ``<stem>_kp.npy``)
are supported alongside ``.mat`` so tests run without mat73 corpora.
``load_wipose_mat`` imports ``mat73`` (or ``h5py``) when it is called, so
the ``.npy`` path needs neither.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

# per-channel normalization constants; overridable per corpus
DEFAULT_MEAN = np.zeros((9,), np.float32)
DEFAULT_STD = np.ones((9,), np.float32)


def load_wipose_mat(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """One WiPose .mat -> (csi [9, 30, 5], keypoints [18, 3])."""
    try:
        import mat73
        data = mat73.loadmat(path)
    except ImportError:
        import h5py
        with h5py.File(path, "r") as f:
            data = {"CSI": np.asarray(f["CSI"]),
                    "SkeletonPoints": np.asarray(f["SkeletonPoints"])}
    csi = np.asarray(data["CSI"], np.float32)
    csi = csi.transpose(3, 2, 1, 0).reshape(9, 30, 5) \
        if csi.ndim == 4 else csi.reshape(9, 30, 5)
    kp = np.asarray(data["SkeletonPoints"], np.float32).reshape(3, 18).T
    xy = kp[:, :2] * 0.001
    return csi, np.concatenate([xy, kp[:, 2:3]], axis=1)


class WiPoseDataset:
    """Directory of per-sample files under ``{root}/{split}/``."""

    def __init__(self, root_dir: str, split: str = "Train",
                 mean: np.ndarray = DEFAULT_MEAN,
                 std: np.ndarray = DEFAULT_STD):
        self.dir = os.path.join(root_dir, split)
        names = sorted(os.listdir(self.dir))
        self.mat_files = [n for n in names if n.endswith(".mat")]
        self.npy_stems = sorted({n[:-8] for n in names
                                 if n.endswith("_csi.npy")})
        self.mean = np.asarray(mean, np.float32).reshape(9, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(9, 1, 1)

    def __len__(self) -> int:
        return len(self.mat_files) + len(self.npy_stems)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if idx < len(self.mat_files):
            csi, kp = load_wipose_mat(
                os.path.join(self.dir, self.mat_files[idx]))
        else:
            stem = self.npy_stems[idx - len(self.mat_files)]
            csi = np.load(os.path.join(self.dir, f"{stem}_csi.npy"))
            kp = np.load(os.path.join(self.dir, f"{stem}_kp.npy"))
        csi = (csi.astype(np.float32) - self.mean) / np.maximum(self.std,
                                                                1e-6)
        return {"input_wifi-csi": csi, "output": kp.astype(np.float32)}

    def materialize(self) -> Tuple[np.ndarray, np.ndarray]:
        csi = np.zeros((len(self), 9, 30, 5), np.float32)
        kp = np.zeros((len(self), 18, 3), np.float32)
        for i in range(len(self)):
            item = self[i]
            csi[i] = item["input_wifi-csi"]
            kp[i] = item["output"]
        return csi, kp

    @staticmethod
    def compute_stats(csi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-channel mean/std (the reference's __main__ block)."""
        return (csi.mean(axis=(0, 2, 3)).astype(np.float32),
                csi.std(axis=(0, 2, 3)).astype(np.float32))


def generate_synthetic_wipose(root_dir: str, per_split: int = 64,
                              seed: int = 0) -> str:
    """Tiny synthetic WiPose tree (.npy sample pairs) for tests/smokes.

    Pose labels are a smooth function of the CSI so small models can
    overfit; the confidence column is ~1 like real OpenPose exports.
    """
    rng = np.random.default_rng(seed)
    for split in ("Train", "Test"):
        d = os.path.join(root_dir, split)
        os.makedirs(d, exist_ok=True)
        for i in range(per_split):
            csi = rng.standard_normal((9, 30, 5)).astype(np.float32)
            drive = csi.mean(axis=(1, 2))                # [9]
            kp = np.zeros((18, 3), np.float32)
            kp[:, 0] = 0.1 * np.sin(np.arange(18) + drive[:2].sum())
            kp[:, 1] = 0.1 * np.cos(np.arange(18) + drive[2:4].sum())
            kp[:, 2] = 1.0
            np.save(os.path.join(d, f"s{i:04d}_csi.npy"), csi)
            np.save(os.path.join(d, f"s{i:04d}_kp.npy"), kp)
    return root_dir
