"""Synthetic CSI/pose data for tests, smoke training, and benchmarks.

A copy of ``wiflow_tpu/data/synthetic.py``: the same numpy RNG calls in
the same order, so the files come out byte-equal to the JAX package's.

The real 360k-sample dataset (5 subjects, 8 activities — ref README.md:38-43)
is not redistributable, so we generate structurally faithful stand-ins:
smooth keypoint trajectories driving the CSI through a random linear map
plus noise.  Because the CSI is informative about the pose, short training
runs show genuinely decreasing loss / increasing PCK — a real end-to-end
signal rather than noise-fitting.

Two entry points:
  * ``generate_raw_dataset`` writes raw ``<id>_csi.npy`` / ``<id>_keypoints.csv``
    recordings so the full preprocessing pipeline is exercised.
  * ``make_preprocessed_dataset`` = generate + preprocess in one call.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from wiflow_tpu_torch.data.preprocess import preprocess_csi_data


def _smooth_walk(rng: np.random.Generator, t: int, dims: int, smooth: int = 15
                 ) -> np.ndarray:
    steps = rng.standard_normal((t + smooth, dims)).astype(np.float32)
    kernel = np.hanning(smooth).astype(np.float32)
    kernel /= kernel.sum()
    out = np.stack([np.convolve(steps[:, d], kernel, mode="same")
                    for d in range(dims)], axis=1)
    return out[:t]


def generate_raw_dataset(
    out_dir: str,
    num_files: int = 12,
    frames_per_file: int = 120,
    num_subcarriers: int = 540,
    num_keypoints_raw: int = 25,
    num_subjects: int = 5,
    zero_dropout: float = 0.01,
    seed: int = 0,
) -> Dict[str, int]:
    """Write raw per-recording CSI + keypoint files.

    Keypoints are mm-scaled (consumer divides by 1000); a small fraction is
    zeroed to exercise the zero-repair paths.  File ids carry subject tags
    (``subject{k}_act{a}``) so LOSO splits are testable.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    # one global mixing map: pose (+velocity) -> subcarrier space
    k2 = num_keypoints_raw * 2
    mix = rng.standard_normal((2 * k2, num_subcarriers)).astype(np.float32)

    for i in range(num_files):
        subject = i % num_subjects + 1
        fid = f"subject{subject}_act{i // num_subjects}"
        base = rng.standard_normal((1, k2)).astype(np.float32) * 0.2
        kp = base + 0.15 * _smooth_walk(rng, frames_per_file, k2)
        vel = np.diff(kp, axis=0, prepend=kp[:1])
        feats = np.concatenate([kp, 5.0 * vel], axis=1)        # [T, 2*k2]
        csi = feats @ mix + 0.05 * rng.standard_normal(
            (frames_per_file, num_subcarriers)).astype(np.float32)
        csi += 1.0  # CSI amplitudes are positive-ish
        np.save(os.path.join(out_dir, f"{fid}_csi.npy"),
                csi.astype(np.float32))

        kp_mm = (kp + 0.5) * 1000.0   # store in mm like the raw CSVs
        if zero_dropout > 0:
            drop = rng.random((frames_per_file, num_keypoints_raw)) < zero_dropout
            kp_mm = kp_mm.reshape(frames_per_file, num_keypoints_raw, 2)
            kp_mm[drop] = 0.0
            kp_mm = kp_mm.reshape(frames_per_file, k2)
        header = ",".join(f"kp{j}_{c}" for j in range(num_keypoints_raw)
                          for c in ("x", "y"))
        np.savetxt(os.path.join(out_dir, f"{fid}_keypoints.csv"), kp_mm,
                   delimiter=",", header=header, comments="")
    return {"num_files": num_files, "frames_per_file": frames_per_file}


def make_preprocessed_dataset(
    root: str,
    num_files: int = 12,
    frames_per_file: int = 120,
    window_size: int = 20,
    stride: int = 1,
    num_subcarriers: int = 540,
    seed: int = 0,
    keep_fast_path: bool = True,
) -> str:
    """Generate raw data and run preprocessing; returns the artifact dir."""
    raw = os.path.join(root, "raw")
    out = os.path.join(root, "preprocessed_csi_data")
    generate_raw_dataset(raw, num_files=num_files,
                         frames_per_file=frames_per_file,
                         num_subcarriers=num_subcarriers, seed=seed)
    preprocess_csi_data(raw, out, window_size=window_size, stride=stride)
    if not keep_fast_path:
        os.remove(os.path.join(out, "all_keypoints.npy"))
        os.remove(os.path.join(out, "file_mappings.pkl"))
    return out
