"""Pose-adjacency-matrix (PAM) labels for the WiSPPN-family baselines.

Counterpart of ``wiflow_tpu/data/pam.py``.  The reference baselines train
against PAM ``.mat`` labels (``keypoints_pam_data/wisppn_labels{1..5}/
{file_id}_dual_cropped_frame_{frame:06d}.mat``, key ``jointsMatrix``
[>=3, K, K]) with a confidence-weighted MSE (ref baseline/WiSPPN/
wisppn.py:978-1000, baseline/PerUnet/perunet.py:137-147); the keypoints
live on the PAM diagonal.

Host numpy (copies of the JAX module's): ``load_pam_mat`` (scipy, and
h5py for MATLAB v7.3 files, both imported where used),
``keypoints_to_pam`` (PAM labels from plain keypoints: diagonal = coords,
off-diagonal = pairwise midpoints, unit confidence; used where the label
directory is absent), ``load_pam_labels_for_windows`` and
``pam_train_kwargs``.  Torch, the trainer's hooks: ``pam_confidence_mse``,
``pam_keypoint_mse``, ``pam_diag_keypoints`` and ``pam_to_keypoints``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from wiflow_tpu_torch.data.splits import infer_subject


def load_pam_mat(path: str, key: str = "jointsMatrix") -> np.ndarray:
    """Load a PAM label matrix [C, K, K] from a .mat file."""
    import scipy.io as scio
    try:
        return np.asarray(scio.loadmat(path)[key], np.float32)
    except NotImplementedError:
        # MATLAB v7.3 files are HDF5
        import h5py
        with h5py.File(path, "r") as f:
            return np.asarray(f[key], np.float32).T


def keypoints_to_pam(kp: np.ndarray, confidence: float = 1.0) -> np.ndarray:
    """[N, K, C] keypoints -> [N, 2C, K, K] PAM labels (coords + conf)."""
    kp = np.asarray(kp, np.float32)
    n, k, c = kp.shape
    mid = 0.5 * (kp[:, :, None, :] + kp[:, None, :, :])     # [N, K, K, C]
    eye = np.eye(k, dtype=np.float32)[None, :, :, None]
    pam = mid * (1 - eye) + kp[:, :, None, :] * eye
    pam = np.transpose(pam, (0, 3, 1, 2))                   # [N, C, K, K]
    conf = np.full_like(pam, confidence)
    return np.concatenate([pam, conf], axis=1)


def pam_confidence_mse(pred: torch.Tensor, label: torch.Tensor):
    """Confidence-weighted MSE (ref wisppn.py:988-1000).

    ``pred`` [B, C, K, K]; ``label`` [B, >=C+1, K, K] with coords in the
    first C channels and confidence in the rest (a single confidence
    channel is broadcast across coords, as wisppn.py:983-987 does)."""
    c = pred.shape[1]
    xy = label[:, :c].float()
    conf = label[:, c:]
    if conf.shape[1] == 1:
        conf = conf.expand(-1, c, -1, -1)
    conf = conf[:, :c].float()
    pred = pred.float()
    loss = ((conf * pred - conf * xy) ** 2).mean()
    return loss, {"position": loss, "bone": torch.zeros_like(loss)}


def pam_keypoint_mse(pred: torch.Tensor, label: torch.Tensor):
    """Confidence-weighted MSE on the keypoints of the PAM label's
    diagonal, for PAM-labelled keypoint regressors (WPformer: ``pred``
    [B, K, D]; ref baseline/WPformer/model.py:504-525, 968-974).  ``label``
    [B, >=D+1, K, K]: coords in the first D channels, confidence in the
    rest (its first channel weighs every coordinate)."""
    d = pred.shape[-1]
    diag = torch.diagonal(label, dim1=-2, dim2=-1)          # [B, C_l, K]
    kp = diag[:, :d].transpose(-1, -2).float()
    conf = diag[:, d:].transpose(-1, -2)[..., :1].float()   # [B, K, 1]
    pred = pred.float()
    loss = ((conf * pred - conf * kp) ** 2).mean()
    return loss, {"position": loss, "bone": torch.zeros_like(loss)}


def pam_diag_keypoints(pred: torch.Tensor, label: torch.Tensor):
    """(pred keypoints, PAM label) -> (pred kp, target kp): the eval
    adapter of a keypoint model trained on PAM labels (WPformer)."""
    d = pred.shape[-1]
    td = torch.diagonal(label[:, :d], dim1=-2, dim2=-1)
    return pred, td.transpose(-1, -2)


def pam_to_keypoints(pred: torch.Tensor, label: torch.Tensor):
    """(pred PAM, PAM label) -> (pred kp, target kp) via the diagonals."""
    c = pred.shape[1]
    pd = torch.diagonal(pred, dim1=-2, dim2=-1)
    td = torch.diagonal(label[:, :c], dim1=-2, dim2=-1)
    return pd.transpose(-1, -2), td.transpose(-1, -2)


def pam_train_kwargs(spec: dict) -> dict:
    """``train_pose_model`` keyword arguments for a baseline spec's labels:
    the full-matrix confidence MSE for PAM-output models (WiSPPN, PerUnet;
    ref wisppn.py:978-1000), the diagonal-keypoint one for keypoint-output
    models (WPformer, ref model.py:968-974); none for keypoint labels."""
    if spec["labels"] != "pam":
        return {}
    if spec.get("pam_target") == "keypoints":
        return dict(loss_fn=pam_keypoint_mse,
                    to_keypoints=pam_diag_keypoints)
    return dict(loss_fn=pam_confidence_mse, to_keypoints=pam_to_keypoints)


def load_pam_labels_for_windows(
    pam_root: str, file_ids, window_to_file, window_to_frame,
    indices: np.ndarray, subject_dirs: Optional[Dict[str, str]] = None,
    num_keypoints: int = 15,
    file_subjects: Optional[Dict[str, int]] = None,
) -> np.ndarray:
    """Batch-load PAM labels by the reference's path convention
    ``{pam_root}/wisppn_labels{subject}/{file_id}_dual_cropped_frame_
    {frame:06d}.mat`` (ref baseline/PerUnet/perunet.py:137-147).

    The subject comes from ``file_subjects`` (file id -> subject) when
    given, else from ``splits.infer_subject`` on the file id, which raises
    rather than guess where the id has no subject tag.  ``subject_dirs``
    and ``num_keypoints`` are accepted for the JAX signature and unused
    there too."""
    out = None
    for row, idx in enumerate(np.asarray(indices)):
        fid = file_ids[int(window_to_file[idx])]
        frame = int(window_to_frame[idx])
        subject = (file_subjects[fid] if file_subjects is not None
                   else infer_subject(fid))
        path = os.path.join(pam_root, f"wisppn_labels{subject}",
                            f"{fid}_dual_cropped_frame_{frame:06d}.mat")
        mat = load_pam_mat(path)
        if out is None:
            out = np.zeros((len(indices), *mat.shape), np.float32)
        out[row] = mat
    return out
