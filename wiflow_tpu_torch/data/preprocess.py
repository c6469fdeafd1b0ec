"""CSI preprocessing: raw per-file recordings -> windowed training artifacts.

Counterpart of ``wiflow_tpu/data/preprocess.py``, a copy of its host code
that needs no pandas: the keypoint CSVs are read with the ``csv`` module.
The reference only consumes a ``preprocessed_csi_data/`` directory (ref
dataset.py:24-66, run.py:72-75); this module writes it, file for file and
array for array as the JAX package does:

  csi_windows.npy    [N, 540, 20] float32 — sliding CSI amplitude windows
  window_info.npz    {window_to_file [N], window_to_frame [N]}
  file_info.npz      {keypoints_files [F], file_ids [F], window_ranges [F,2]}
  config.npz         {window_size, stride}
  all_keypoints.npy  [total_frames, 15, 2] float32 (fast 'npy mode')
  file_mappings.pkl  {keypoints_csv_path: {'start_idx': int, 'num_frames': int}}

Raw inputs are per-recording pairs: a CSI array ``<id>_csi.npy`` of shape
[T, 540] (amplitudes) and a keypoint CSV ``<id>_keypoints.csv`` with one
row per frame and the last 50 columns holding 25 OpenPose (x, y) pairs in
millimetres (the consumer keeps the first 15 keypoints and divides by 1000;
ref: dataset.py:137-151).

Windowing convention (ours to define): window ``i`` of a file covers frames
``[i*stride, i*stride + window_size)`` and is labelled with the *last* frame
of the window — the causal-TCN-aligned choice (the model's temporal stack is
strictly causal, ref models/tcn.py:6-12, so the freshest frame is the one
the features are centred on).
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

KEEP_KEYPOINTS = list(range(15))       # ref: dataset.py:13
RAW_KEYPOINTS = 25
KEYPOINT_COLS = RAW_KEYPOINTS * 2


def window_count(num_frames: int, window_size: int, stride: int) -> int:
    if num_frames < window_size:
        return 0
    return (num_frames - window_size) // stride + 1


def window_csi(csi: np.ndarray, window_size: int, stride: int) -> np.ndarray:
    """[T, S] -> [N, S, window_size] sliding windows (stride along time)."""
    t, s = csi.shape
    n = window_count(t, window_size, stride)
    if n == 0:
        return np.zeros((0, s, window_size), np.float32)
    sw = np.lib.stride_tricks.sliding_window_view(csi, window_size, axis=0)
    return np.ascontiguousarray(sw[::stride][:n], dtype=np.float32)


def load_keypoints_csv(path: str, keypoint_scale: float = 1000.0) -> np.ndarray:
    """Keypoint CSV -> [frames, 15, 2] scaled, mirroring dataset.py:137-151.

    Skips the header row, takes the last 50 columns when more are present,
    keeps the first 15 keypoints, divides by ``keypoint_scale``.  An empty
    field reads as NaN, as pandas reads it.
    """
    with open(path, newline="") as f:
        rows = [r[-KEYPOINT_COLS:] for r in csv.reader(f)][1:]
    data = np.array([[float(v) if v.strip() else np.nan for v in r]
                     for r in rows if r], np.float64).reshape(-1, KEYPOINT_COLS)
    data = data.astype(np.float32) / keypoint_scale
    kp = data.reshape(len(data), RAW_KEYPOINTS, 2)
    return kp[:, KEEP_KEYPOINTS, :]


def discover_raw_files(raw_dir: str) -> List[Tuple[str, str, str]]:
    """Return sorted [(file_id, csi_path, keypoints_path)] pairs."""
    out = []
    for name in sorted(os.listdir(raw_dir)):
        if name.endswith("_csi.npy"):
            fid = name[: -len("_csi.npy")]
            kp = os.path.join(raw_dir, f"{fid}_keypoints.csv")
            if os.path.exists(kp):
                out.append((fid, os.path.join(raw_dir, name), kp))
    return out


def preprocess_csi_data(
    raw_dir: str,
    out_dir: str,
    window_size: int = 20,
    stride: int = 1,
    keypoint_scale: float = 1000.0,
) -> Dict[str, int]:
    """Produce the full §2.6 artifact set from raw recordings.

    Also materializes the fast-path keypoint artifacts in one pass
    (the reference splits this over two absent scripts).
    """
    os.makedirs(out_dir, exist_ok=True)
    files = discover_raw_files(raw_dir)
    if not files:
        raise FileNotFoundError(f"no '<id>_csi.npy' + '<id>_keypoints.csv' "
                                f"pairs found in {raw_dir}")

    windows, w2file, w2frame, ranges = [], [], [], []
    kp_files, file_ids = [], []
    all_kp, mappings = [], {}
    total_windows = 0
    total_frames = 0

    for file_idx, (fid, csi_path, kp_path) in enumerate(files):
        csi = np.load(csi_path).astype(np.float32)          # [T, S]
        kp = load_keypoints_csv(kp_path, keypoint_scale)    # [T', 15, 2]
        win = window_csi(csi, window_size, stride)          # [n, S, W]
        n = len(win)
        # label = last frame of each window
        frames = np.arange(n) * stride + (window_size - 1)
        frames = np.minimum(frames, len(kp) - 1)

        windows.append(win)
        w2file.append(np.full(n, file_idx, np.int32))
        w2frame.append(frames.astype(np.int32))
        ranges.append((total_windows, total_windows + n))
        kp_files.append(kp_path)
        file_ids.append(fid)
        mappings[kp_path] = {"start_idx": total_frames, "num_frames": len(kp)}
        all_kp.append(kp)
        total_windows += n
        total_frames += len(kp)

    np.save(os.path.join(out_dir, "csi_windows.npy"),
            np.concatenate(windows, axis=0))
    np.savez(os.path.join(out_dir, "window_info.npz"),
             window_to_file=np.concatenate(w2file),
             window_to_frame=np.concatenate(w2frame))
    np.savez(os.path.join(out_dir, "file_info.npz"),
             keypoints_files=np.array(kp_files),
             file_ids=np.array(file_ids),
             window_ranges=np.array(ranges, np.int64))
    np.savez(os.path.join(out_dir, "config.npz"),
             window_size=np.int64(window_size), stride=np.int64(stride))
    np.save(os.path.join(out_dir, "all_keypoints.npy"),
            np.concatenate(all_kp, axis=0).astype(np.float32))
    with open(os.path.join(out_dir, "file_mappings.pkl"), "wb") as f:
        pickle.dump(mappings, f)

    return {"num_files": len(files), "num_windows": total_windows,
            "num_frames": total_frames}


def clean_single_frame_zeros(kp: np.ndarray) -> np.ndarray:
    """Vectorized zero-keypoint repair, npy mode (ref: dataset.py:105-120).

    Zero (x, y) keypoints are replaced with the mean of the frame's
    non-zero keypoints.  Works on ``[..., K, 2]``.
    """
    nz = (kp[..., 0] != 0) | (kp[..., 1] != 0)               # [..., K]
    cnt = np.maximum(nz.sum(axis=-1, keepdims=True), 1)      # [..., 1]
    mean = (kp * nz[..., None]).sum(axis=-2, keepdims=True) / cnt[..., None]
    any_nz = nz.any(axis=-1)[..., None, None]
    return np.where(nz[..., None], kp, np.where(any_nz, mean, kp))


def clean_zero_keypoints_temporal(kp_seq: np.ndarray) -> np.ndarray:
    """Temporal zero repair, CSV mode (ref: dataset.py:158-201), vectorized.

    Per keypoint track: linear interpolation between the nearest non-zero
    frames; edge gaps take the nearest valid frame.
    """
    t, k, _ = kp_seq.shape
    out = kp_seq.copy()
    valid = (kp_seq[..., 0] != 0) | (kp_seq[..., 1] != 0)    # [T, K]
    idx = np.arange(t)
    for j in range(k):
        v = valid[:, j]
        if v.all() or not v.any():
            continue
        vt = idx[v]
        for d in range(2):
            out[:, j, d] = np.interp(idx, vt, kp_seq[v, j, d])
    return out
