"""MM-Fi dataset layer (Setting 3, cross-dataset transfer).

A copy of ``wiflow_tpu/data/mmfi.py`` in numpy, with the same names,
on-disk contract and split semantics (ref cross_dataset_test/mmfi.py):

  * the tree ``E0x/Sxx/Axx/<modality>``; subjects S01-S40 map to scenes
    by decade (mmfi.py:141-151),
  * the protocol1/2/3 action subsets and the four split modes, with
    random_split's ``np.random.seed`` reset per action to an
    incrementing seed (mmfi.py:20-48),
  * CSI frames: ``CSIamp`` ``[3, 114, 10]``, inf -> NaN, each time slice's
    NaNs filled with its non-NaN mean, min-max normalization
    (mmfi.py:269-278),
  * frame data units, where a zero-byte file of any requested modality
    drops the frame (mmfi.py:181-199),
  * labels: ``ground_truth.npy`` ``[297, 17, 3]`` per action sequence.

The WiFi-CSI split is read once into dense arrays (``materialize``, with
an ``.npz`` cache) that the trainer copies to the device.  Nothing here
imports sklearn, PyYAML or OpenCV at module level: ``split_val_test``
draws sklearn's permutation with numpy, and OpenCV is imported only where
a depth frame is read or written.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ALL_SUBJECTS = [f"S{i:02d}" for i in range(1, 41)]
ALL_ACTIONS = [f"A{i:02d}" for i in range(1, 28)]
PROTOCOL1_ACTIONS = ["A02", "A03", "A04", "A05", "A13", "A14", "A17", "A18",
                     "A19", "A20", "A21", "A22", "A23", "A27"]
PROTOCOL2_ACTIONS = ["A01", "A06", "A07", "A08", "A09", "A10", "A11", "A12",
                     "A15", "A16", "A24", "A25", "A26"]
FRAMES_PER_SEQUENCE = 297


def scene_of(subject: str) -> str:
    idx = int(subject[1:])
    if not 1 <= idx <= 40:
        raise ValueError(f"unknown subject {subject}")
    return f"E{(idx - 1) // 10 + 1:02d}"


def protocol_actions(protocol: str) -> List[str]:
    if protocol == "protocol1":
        return list(PROTOCOL1_ACTIONS)
    if protocol == "protocol2":
        return list(PROTOCOL2_ACTIONS)
    return list(ALL_ACTIONS)


def decode_config(config: Dict) -> Dict:
    """YAML config -> {subject: [actions]} train/val forms (mmfi.py:11-82)."""
    actions = protocol_actions(config["protocol"])
    train_form: Dict[str, List[str]] = {}
    val_form: Dict[str, List[str]] = {}

    split = config["split_to_use"]
    if split == "random_split":
        rs = config["random_split"]["random_seed"]
        ratio = config["random_split"]["ratio"]
        for action in actions:
            # the reference reseeds per action with an incrementing seed
            np.random.seed(rs)
            idx = np.random.permutation(len(ALL_SUBJECTS))
            cut = int(np.floor(ratio * len(ALL_SUBJECTS)))
            subjects_train = {ALL_SUBJECTS[i] for i in idx[:cut]}
            subjects_val = {ALL_SUBJECTS[i] for i in idx[cut:]}
            for subject in ALL_SUBJECTS:
                if subject in subjects_train:
                    train_form.setdefault(subject, []).append(action)
                if subject in subjects_val:
                    val_form.setdefault(subject, []).append(action)
            rs += 1
    elif split == "cross_scene_split":
        for subject in ALL_SUBJECTS[:30]:
            train_form[subject] = actions
        for subject in ALL_SUBJECTS[30:]:
            val_form[subject] = actions
    elif split == "cross_subject_split":
        cross = config["cross_subject_split"]
        for subject in cross["train_dataset"]["subjects"]:
            train_form[subject] = actions
        for subject in cross["val_dataset"]["subjects"]:
            val_form[subject] = actions
    else:
        man = config["manual_split"]
        for subject in man["train_dataset"]["subjects"]:
            train_form[subject] = man["train_dataset"]["actions"]
        for subject in man["val_dataset"]["subjects"]:
            val_form[subject] = man["val_dataset"]["actions"]

    return {"train": train_form, "val": val_form}


def load_csi_frame(path: str) -> np.ndarray:
    """One CSI frame -> [3, 114, 10] float32, NaN-repaired + min-max normed.

    Mirrors mmfi.py:269-278 exactly, including the quirk that the NaN fill
    value is the mean over the frame's non-NaN entries of each [3, 114]
    time slice.  Accepts ``.mat`` (key ``CSIamp``) or ``.npy``.
    """
    if path.endswith(".npy"):
        data = np.load(path).astype(np.float64)
    else:
        import scipy.io as scio
        data = scio.loadmat(path)["CSIamp"].astype(np.float64)
    data[np.isinf(data)] = np.nan
    for t in range(data.shape[-1]):
        col = data[:, :, t]
        if np.isnan(col).any():
            col[np.isnan(col)] = col[~np.isnan(col)].mean()
    dmin, dmax = np.min(data), np.max(data)
    return ((data - dmin) / (dmax - dmin)).astype(np.float32)


MODALITIES = ("rgb", "infra1", "infra2", "depth", "lidar", "mmwave",
              "wifi-csi")
# reference file-type map (mmfi.py:153-163)
MODALITY_EXTS = {"rgb": (".npy",), "infra1": (".npy",), "infra2": (".npy",),
                 "depth": (".png",), "lidar": (".bin",), "mmwave": (".bin",),
                 "wifi-csi": (".mat", ".npy")}


def load_modality_frame(path: str, mod: str) -> np.ndarray:
    """One frame of any modality (mmfi.py:250-280 ``read_frame``):

      rgb/infra1/infra2  .npy 2-D keypoints,
      depth              16-bit .png scaled to meters (x0.001),
      lidar              raw float64 .bin -> [-1, 3] points,
      mmwave             raw float64 .bin -> [-1, 5] points,
      wifi-csi           .mat CSIamp with NaN repair + min-max norm.
    """
    if mod == "wifi-csi":
        return load_csi_frame(path)
    if mod in ("rgb", "infra1", "infra2"):
        return np.load(path).astype(np.float32)
    if mod == "depth":
        import cv2
        return (cv2.imread(path, cv2.IMREAD_UNCHANGED)
                .astype(np.float32) * 0.001)
    if mod in ("lidar", "mmwave"):
        with open(path, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.float64)
        return raw.reshape(-1, 3 if mod == "lidar" else 5).astype(np.float32)
    raise ValueError(f"unseen modality {mod!r}")


def read_modality_dir(dir_path: str, mod: str):
    """All frames of one modality directory (mmfi.py:204-248 ``read_dir``).

    Returns a dense [T, ...] array for fixed-shape modalities and a list
    of [N_t, D] arrays for the point-cloud ones (lidar/mmwave)."""
    import glob as _glob
    pats = [os.path.join(dir_path, f"frame*{ext}")
            for ext in MODALITY_EXTS[mod]]
    files = sorted(sum((_glob.glob(p) for p in pats), []))
    frames = [load_modality_frame(f, mod) for f in files]
    if mod in ("lidar", "mmwave"):
        return frames
    return np.asarray(frames)


class MMFiDataset:
    """MM-Fi dataset over a {subject: [actions]} form.

    ``data_unit='frame'`` yields per-frame samples (zero-byte frames of
    ANY requested modality invalidate the whole frame, mmfi.py:193-199);
    ``data_unit='sequence'`` yields one sample per (subject, action) with
    whole-sequence inputs (mmfi.py:169-181, 291-304).  ``modality`` is a
    '|'-separated list as in the reference YAML.
    """

    def __init__(self, data_root: str, data_form: Dict[str, List[str]],
                 modality: str = "wifi-csi", data_unit: str = "frame"):
        mods = modality.split("|")
        for m in mods:
            if m not in MODALITIES:
                raise ValueError(f"unknown modality {m!r}")
        if data_unit not in ("frame", "sequence"):
            raise ValueError(f"unsupported data unit {data_unit!r}")
        self.data_root = data_root
        self.modality = mods
        self.data_unit = data_unit
        self.items: List[Dict] = []
        for subject in sorted(data_form):
            scene = scene_of(subject)
            for action in data_form[subject]:
                base = os.path.join(data_root, scene, subject, action)
                gt_path = os.path.join(base, "ground_truth.npy")
                mod_dirs = {m: os.path.join(base, m) for m in mods}
                if not all(os.path.isdir(d) for d in mod_dirs.values()):
                    continue
                if data_unit == "sequence":
                    self.items.append({
                        "scene": scene, "subject": subject, "action": action,
                        "mod_dirs": mod_dirs, "gt_path": gt_path,
                    })
                    continue
                for idx in range(FRAMES_PER_SEQUENCE):
                    paths = {m: self._frame_path(d, idx, m)
                             for m, d in mod_dirs.items()}
                    if any(p is None for p in paths.values()):
                        continue
                    self.items.append({
                        "scene": scene, "subject": subject, "action": action,
                        "idx": idx, "frame_paths": paths, "gt_path": gt_path,
                        # kept for the single-modality fast path
                        "frame_path": paths.get("wifi-csi"),
                    })

    @staticmethod
    def _frame_path(mod_dir: str, idx: int,
                    mod: str = "wifi-csi") -> Optional[str]:
        for ext in MODALITY_EXTS[mod]:
            p = os.path.join(mod_dir, f"frame{idx + 1:03d}{ext}")
            # zero-size files are invalid frames (mmfi.py:196-198)
            if os.path.isfile(p) and os.path.getsize(p) > 0:
                return p
        return None

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Dict:
        item = self.items[i]
        gt = np.load(item["gt_path"])
        if self.data_unit == "sequence":
            sample = {
                "modality": list(self.modality),
                "scene": item["scene"], "subject": item["subject"],
                "action": item["action"],
                "output": gt.astype(np.float32),
            }
            for mod, d in item["mod_dirs"].items():
                sample[f"input_{mod}"] = read_modality_dir(d, mod)
            return sample
        sample = {
            "modality": list(self.modality),
            "scene": item["scene"], "subject": item["subject"],
            "action": item["action"], "idx": item["idx"],
            "output": gt[item["idx"]].astype(np.float32),
        }
        for mod, p in item["frame_paths"].items():
            sample[f"input_{mod}"] = load_modality_frame(p, mod)
        return sample

    def materialize(self, cache_path: Optional[str] = None,
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense (csi [N,3,114,10], keypoints [N,17,3]) for the device.

        Frame-unit WiFi-CSI only — the modality the compute models consume;
        other modalities are served per-sample via ``__getitem__`` +
        ``pad_collate``."""
        if self.data_unit != "frame" or "wifi-csi" not in self.modality:
            raise ValueError("materialize() requires frame-unit wifi-csi")
        if cache_path and os.path.exists(cache_path):
            z = np.load(cache_path)
            if len(z["csi"]) == len(self):
                return z["csi"], z["kp"]
        csi = np.zeros((len(self), 3, 114, 10), np.float32)
        kp = np.zeros((len(self), 17, 3), np.float32)
        gt_cache: Dict[str, np.ndarray] = {}
        for i, item in enumerate(self.items):
            csi[i] = load_csi_frame(item["frame_path"])
            if item["gt_path"] not in gt_cache:
                gt_cache[item["gt_path"]] = np.load(item["gt_path"])
                if len(gt_cache) > 8:
                    gt_cache.pop(next(iter(gt_cache)))
            kp[i] = gt_cache[item["gt_path"]][item["idx"]]
        if cache_path:
            np.savez(cache_path, csi=csi, kp=kp)
        return csi, kp


def make_dataset(dataset_root: str, config: Dict,
                 ) -> Tuple[MMFiDataset, MMFiDataset]:
    """(train, val) datasets from a YAML config dict (mmfi.py:326-331)."""
    forms = decode_config(config)
    unit = config.get("data_unit", "frame")
    return (MMFiDataset(dataset_root, forms["train"], config["modality"],
                        unit),
            MMFiDataset(dataset_root, forms["val"], config["modality"],
                        unit))


def pad_collate(batch: Sequence[Dict]) -> Dict:
    """Batch samples into dense numpy arrays, zero-padding the
    variable-length point-cloud modalities (mmwave/lidar) to the batch
    max — the reference's ``collate_fn_padd`` (mmfi.py:334-360), in
    numpy."""
    out = {"modality": batch[0]["modality"],
           "scene": [s["scene"] for s in batch],
           "subject": [s["subject"] for s in batch],
           "action": [s["action"] for s in batch],
           "idx": [s["idx"] for s in batch] if "idx" in batch[0] else None,
           "output": np.asarray([np.asarray(s["output"]) for s in batch],
                                np.float32)}
    for mod in out["modality"]:
        key = f"input_{mod}"
        if mod in ("mmwave", "lidar"):
            if not isinstance(batch[0][key], list):  # frame unit: [N_t, D]
                seqs = [np.asarray(s[key], np.float32) for s in batch]
                max_n = max(len(q) for q in seqs)
                dense = np.zeros((len(seqs), max_n, seqs[0].shape[-1]),
                                 np.float32)
                for i, q in enumerate(seqs):
                    dense[i, :len(q)] = q
            else:  # sequence unit: list of [N_t, D] per sample
                seqs = [[np.asarray(f, np.float32) for f in s[key]]
                        for s in batch]
                t_max = max(len(q) for q in seqs)
                n_max = max(len(f) for q in seqs for f in q)
                d = seqs[0][0].shape[-1]
                dense = np.zeros((len(seqs), t_max, n_max, d), np.float32)
                for i, q in enumerate(seqs):
                    for t, f in enumerate(q):
                        dense[i, t, :len(f)] = f
            out[key] = dense
        else:
            out[key] = np.asarray([np.asarray(s[key]) for s in batch],
                                  np.float32)
    return out


def split_val_test(val_items_count: int, seed: int = 41,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """50/50 val/test split of the validation set: the reference's
    ``sklearn.train_test_split(arange(n), test_size=0.5, random_state=41)``
    (wiflow.py:1818), drawn as sklearn draws it: one permutation from
    ``np.random.RandomState(seed)``, its first ``ceil(n / 2)`` entries the
    test split and the rest the val split.  Like sklearn, it raises
    ``ValueError`` where the val split would be empty (n < 2)."""
    n = int(val_items_count)
    n_test = math.ceil(0.5 * n)
    if n - n_test <= 0:
        raise ValueError(
            f"With n_samples={n}, test_size=0.5 and train_size=None, the "
            f"resulting train set will be empty. Adjust any of the "
            f"aforementioned parameters.")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def generate_synthetic_mmfi(root: str,
                            subjects: Sequence[str] = ("S01", "S02"),
                            actions: Sequence[str] = ("A01", "A02"),
                            frames: int = 24, seed: int = 0,
                            fmt: str = "mat",
                            modalities: Sequence[str] = ("wifi-csi",),
                            learnable: bool = False) -> None:
    """Write a miniature MM-Fi tree (per-modality frames + ground truth)
    for tests.  Point-cloud modalities get variable frame lengths to
    exercise the padding collate.

    ``learnable=True`` derives each CSI frame from its ground-truth pose
    through one fixed random mixing map (plus noise), so models can
    actually learn the CSI->pose mapping — required for meaningful
    noise-robustness sweeps (independent random CSI/GT collapses every
    model to the mean pose and flattens any sweep).  The mixing basis is
    smoothed along the 114-subcarrier axis to mimic real CSI's smooth
    frequency response: conv nets can then integrate it with local
    receptive fields, and white AWGN is genuinely separable from the
    signal by the traditional smoothing filters mode 2 sweeps."""
    rng = np.random.default_rng(seed)
    if learnable:
        # scipy only needed for the smoothed mixing basis of learnable
        # trees — keep the import (and the basis construction) out of
        # the plain random-tree path
        from scipy.ndimage import gaussian_filter1d
        mix = np.random.default_rng(1234).standard_normal(
            (17 * 3, 3, 114, 10)).astype(np.float32)
        mix = gaussian_filter1d(mix, sigma=6.0, axis=2)
        mix = (mix / mix.std() * 0.6).reshape(17 * 3, 3 * 114 * 10)
        # Real human poses live on a low-dimensional manifold; the HPE-Li
        # models' pooling bottlenecks rely on that.  Draw learnable-mode
        # poses from an 8-dim latent so they can, too.
        pose_basis = np.random.default_rng(4321).standard_normal(
            (8, 17 * 3)).astype(np.float32)
        pose_basis /= np.linalg.norm(pose_basis, axis=1, keepdims=True)
    for subject in subjects:
        scene = scene_of(subject)
        for action in actions:
            base = os.path.join(root, scene, subject, action)
            if learnable:
                latent = rng.standard_normal(
                    (FRAMES_PER_SEQUENCE, 8)).astype(np.float32)
                gt = (latent @ pose_basis).reshape(-1, 17, 3) * (0.3 * 2.5)
                # MM-Fi-realistic z: camera-depth-scale positive values.
                # The HPE-Li loss uses z as the CONFIDENCE weight
                # (main.py:125-131); near-zero synthetic z would shrink
                # its gradients ~100x vs the real dataset.
                gt[..., 2] += 2.5
            else:
                gt = rng.standard_normal(
                    (FRAMES_PER_SEQUENCE, 17, 3)).astype(np.float32) * 0.3
            os.makedirs(base, exist_ok=True)
            np.save(os.path.join(base, "ground_truth.npy"), gt)
            for modality in modalities:
                mod = os.path.join(base, modality)
                os.makedirs(mod, exist_ok=True)
                for idx in range(frames):
                    stem = os.path.join(mod, f"frame{idx + 1:03d}")
                    if modality == "wifi-csi":
                        if learnable:
                            kp = gt[idx % FRAMES_PER_SEQUENCE].reshape(-1)
                            frame = (kp @ mix).reshape(3, 114, 10) \
                                + rng.standard_normal((3, 114, 10)) * 0.3 + 10
                        else:
                            frame = rng.standard_normal((3, 114, 10)) * 2 + 10
                        if idx % 7 == 3:   # exercise the NaN-repair path
                            frame[0, :5, 2] = np.nan
                        if fmt == "mat":
                            import scipy.io as scio
                            scio.savemat(stem + ".mat", {"CSIamp": frame})
                        else:
                            np.save(stem + ".npy", frame)
                    elif modality in ("rgb", "infra1", "infra2"):
                        np.save(stem + ".npy",
                                rng.standard_normal((17, 2))
                                .astype(np.float32))
                    elif modality == "depth":
                        import cv2
                        img = (rng.uniform(500, 4000, (24, 32))
                               .astype(np.uint16))
                        cv2.imwrite(stem + ".png", img)
                    else:  # lidar / mmwave: variable-length point clouds
                        d = 3 if modality == "lidar" else 5
                        n = int(rng.integers(5, 40))
                        (rng.standard_normal((n, d)).astype(np.float64)
                         .tofile(stem + ".bin"))
