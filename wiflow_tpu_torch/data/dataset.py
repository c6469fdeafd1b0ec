"""Array-resident CSI/keypoint dataset over the preprocessed artifacts.

A copy of ``wiflow_tpu/data/dataset.py`` (ref dataset.py:16-253): instead
of a per-sample ``__getitem__`` and a DataLoader, the dataset is
materialized once into dense numpy arrays, which the trainer copies to the
device; a batch is a gather there.

Both label modes of the reference are supported:
  * npy fast mode: ``all_keypoints.npy`` + ``file_mappings.pkl`` with
    single-frame zero repair (ref dataset.py:80-120),
  * CSV fallback: per-file keypoint CSVs with temporal-interpolation zero
    repair (ref dataset.py:122-215).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from wiflow_tpu_torch.data.preprocess import (
    clean_single_frame_zeros,
    clean_zero_keypoints_temporal,
    load_keypoints_csv,
)


class CSIKeypointsDataset:
    """Loads the preprocessed artifact directory into memory.

    Attributes:
      csi_windows:    [N, S, W] float32
      window_to_file: [N] int
      window_to_frame:[N] int
      window_ranges:  [F, 2] per-file [start, end) sample ranges
    """

    def __init__(self, data_dir: str, keypoint_scale: float = 1000.0,
                 enable_temporal_clean: bool = True):
        self.data_dir = data_dir
        self.keypoint_scale = keypoint_scale
        self.enable_temporal_clean = enable_temporal_clean

        self.csi_windows = np.load(os.path.join(data_dir, "csi_windows.npy"),
                                   mmap_mode="r")
        winfo = np.load(os.path.join(data_dir, "window_info.npz"))
        self.window_to_file = winfo["window_to_file"]
        self.window_to_frame = winfo["window_to_frame"]
        finfo = np.load(os.path.join(data_dir, "file_info.npz"),
                        allow_pickle=True)
        self.keypoints_files = [str(p) for p in finfo["keypoints_files"]]
        self.file_ids = [str(p) for p in finfo["file_ids"]]
        self.window_ranges = np.asarray(finfo["window_ranges"], np.int64)
        cfg = np.load(os.path.join(data_dir, "config.npz"))
        self.window_size = int(cfg["window_size"])
        self.stride = int(cfg["stride"])

        kp_path = os.path.join(data_dir, "all_keypoints.npy")
        map_path = os.path.join(data_dir, "file_mappings.pkl")
        self.use_npy_mode = os.path.exists(kp_path) and os.path.exists(map_path)
        if self.use_npy_mode:
            self.all_keypoints = np.load(kp_path)
            with open(map_path, "rb") as f:
                self.file_mappings: Dict[str, Dict] = pickle.load(f)
        else:
            self.all_keypoints = None
            self.file_mappings = None
            self._csv_cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.csi_windows)

    @property
    def num_files(self) -> int:
        return len(self.keypoints_files)

    def get_file_indices(self) -> List[int]:
        return list(range(self.num_files))

    def get_samples_from_file(self, file_idx: int) -> np.ndarray:
        start, end = self.window_ranges[file_idx]
        return np.arange(start, end)

    # -- label materialization ------------------------------------------

    def _file_keypoints_csv(self, file_idx: int) -> np.ndarray:
        if file_idx not in self._csv_cache:
            kp = load_keypoints_csv(self.keypoints_files[file_idx],
                                    self.keypoint_scale)
            if self.enable_temporal_clean:
                kp = clean_zero_keypoints_temporal(kp)
            self._csv_cache[file_idx] = kp
        return self._csv_cache[file_idx]

    def keypoints_for(self, indices: np.ndarray) -> np.ndarray:
        """Labels for a batch of window indices -> [n, 15, 2] float32."""
        indices = np.asarray(indices)
        if self.use_npy_mode:
            file_idx = self.window_to_file[indices]
            frame_idx = self.window_to_frame[indices]
            starts = np.asarray(
                [self.file_mappings[self.keypoints_files[f]]["start_idx"]
                 for f in file_idx], np.int64)
            gidx = np.minimum(starts + frame_idx, len(self.all_keypoints) - 1)
            kp = self.all_keypoints[gidx].astype(np.float32)
            if self.enable_temporal_clean:
                kp = clean_single_frame_zeros(kp)
            return kp
        out = np.zeros((len(indices), 15, 2), np.float32)
        for i, idx in enumerate(indices):
            seq = self._file_keypoints_csv(int(self.window_to_file[idx]))
            out[i] = seq[min(int(self.window_to_frame[idx]), len(seq) - 1)]
        return out

    def materialize(self, indices: Optional[np.ndarray] = None,
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense (csi, keypoints) arrays for staging on the device."""
        if indices is None:
            indices = np.arange(len(self))
        indices = np.asarray(indices)
        csi = np.ascontiguousarray(self.csi_windows[indices], dtype=np.float32)
        kp = self.keypoints_for(indices)
        return csi, kp
