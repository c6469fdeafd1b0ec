"""Host-side result artifacts, file-compatible with the reference.

Counterpart of ``wiflow_tpu/eval/artifacts.py`` (ref train.py:496-572 and
visualization/pose_viz.py), written with the ``csv`` module instead of
pandas: each CSV has the JAX package's header, index column and values,
formatted as pandas formats them (a float64 as ``repr``, a float32 as its
shortest form, NaN as an empty field).

  test_predictions.csv      true/pred x/y per keypoint, x1000 rescale,
                            sample_id index (pose_viz.py:108-134)
  keypoint_error_stats.csv  per-keypoint error stats over the first 1000
                            samples (pose_viz.py:137-166)
  test_results_summary.csv  Metric/Value rows (train.py:516-524)
  training_history.csv      one row per epoch, all history series
  training_history.png      6-panel curve figure (pose_viz.py:168-256)

The PNG needs matplotlib and the videos (``eval/video.py``) need OpenCV;
where either cannot be imported, ``write_all_artifacts`` prints one line
naming the files it skipped and why, and writes the rest.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from wiflow_tpu_torch.core.config import KEYPOINT_NAMES, SKELETON_CONNECTIONS
from wiflow_tpu_torch.metrics.metrics import pck_per_keypoint

KEYPOINT_GROUPS = {
    "head": [0],
    "torso": [1, 8],
    "left_arm": [2, 3, 4],
    "right_arm": [5, 6, 7],
    "left_leg": [9, 10, 11],
    "right_leg": [12, 13, 14],
}
# Per-joint PCK normalizers of the reference's evaluators by keypoint
# count: (scale_a, scale_b, clamp) (ref baseline/WPformer/evaluation.py:
# 6-83; the JAX package's compute_pck_pckh_15 / compute_pck_pckh /
# compute_pck_pckh_18).
PCK_SCALES = {15: (2, 12, 1e-6), 17: (5, 12, None), 18: (6, 13, None)}


def _body_part(idx: int) -> str:
    for part, ids in KEYPOINT_GROUPS.items():
        if idx in ids:
            return part
    return "unknown"


def _field(v: Any) -> str:
    """One CSV field as pandas writes it."""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else str(v)
    return str(v)


def _write_csv(path: str, header: Sequence[str],
               rows: List[Sequence[Any]]) -> str:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([_field(v) for v in row] for row in rows)
    return path


def save_all_predictions(true_kp: np.ndarray, pred_kp: np.ndarray,
                         output_file: str,
                         keypoint_scale: float = 1000.0) -> str:
    """true/pred keypoint dump, columns true_kp{i}_x/y, pred_kp{i}_x/y."""
    n = min(len(true_kp), len(pred_kp))
    k = true_kp.shape[-2] if true_kp.ndim == 3 else 15
    d = true_kp.shape[-1] if true_kp.ndim == 3 else 2
    axes = "xyz"[:d]
    t = np.asarray(true_kp[:n]).reshape(n, k, d) * keypoint_scale
    p = np.asarray(pred_kp[:n]).reshape(n, k, d) * keypoint_scale
    cols = []
    for i in range(k):
        for pre in ("true", "pred"):
            cols.extend(f"{pre}_kp{i}_{a}" for a in axes)
    data = np.concatenate([t[:, :, None, :], p[:, :, None, :]],
                          axis=2).reshape(n, k * 2 * d)
    return _write_csv(output_file, ["sample_id", *cols],
                      [[i, *row] for i, row in enumerate(data)])


def _per_keypoint_pck(true_unscaled: np.ndarray, pred_unscaled: np.ndarray,
                      thr: float) -> Optional[np.ndarray]:
    """Per-joint PCK in percent by the reference's evaluator for the
    keypoint count, on x/y; None for counts it has no evaluator for."""
    k = true_unscaled.shape[1]
    if k not in PCK_SCALES:
        return None
    a, b, clamp = PCK_SCALES[k]
    pck = pck_per_keypoint(torch.from_numpy(np.asarray(
        pred_unscaled[..., :2], np.float32)), torch.from_numpy(np.asarray(
            true_unscaled[..., :2], np.float32)), thr, a, b, clamp)
    return pck.numpy()[:k]


def calculate_keypoint_errors(true_kp: np.ndarray, pred_kp: np.ndarray,
                              keypoint_scale: float = 1000.0,
                              names: Optional[Dict[int, str]] = None
                              ) -> List[Dict[str, Any]]:
    """Per-keypoint error stats (mean/median/std/min/max) and per-joint
    PCK@0.2/0.5, one dict a keypoint, in the CSV's column order."""
    names = names or KEYPOINT_NAMES
    n = min(len(true_kp), len(pred_kp))
    t0 = np.asarray(true_kp[:n]).reshape(n, -1, true_kp.shape[-1])
    p0 = np.asarray(pred_kp[:n]).reshape(n, t0.shape[1], -1)
    t = t0 * keypoint_scale
    p = p0 * keypoint_scale
    dist = np.sqrt(((t - p) ** 2).sum(-1))
    pck20 = _per_keypoint_pck(t0, p0, 0.2)
    pck50 = _per_keypoint_pck(t0, p0, 0.5)
    rows = []
    for i in range(t0.shape[1]):
        di = dist[:, i]
        row = {
            "keypoint_id": i,
            "keypoint_name": names.get(i, f"kp{i}"),
            "body_part": _body_part(i),
            "mean_error": float(di.mean()),
            "median_error": float(np.median(di)),
            "std_error": float(di.std()),
            "min_error": float(di.min()),
            "max_error": float(di.max()),
        }
        if pck20 is not None:
            row["pck@0.2"] = float(pck20[i])
            row["pck@0.5"] = float(pck50[i])
        rows.append(row)
    return rows


def save_keypoint_errors(rows: List[Dict[str, Any]], output_file: str) -> str:
    """The stats of :func:`calculate_keypoint_errors` with pandas' unnamed
    index column."""
    header = list(rows[0]) if rows else []
    return _write_csv(output_file, ["", *header],
                      [[i, *r.values()] for i, r in enumerate(rows)])


def save_test_summary(test_metrics: Dict[str, float], output_file: str) -> str:
    """Metric/Value summary rows matching train.py:516-524."""
    rows = [["Loss", test_metrics["loss"]], ["MPE", test_metrics["mpe"]]]
    for key in sorted(k for k in test_metrics if k.startswith("pck@")):
        rows.append(["PCK@" + key.split("@")[1], test_metrics[key]])
    return _write_csv(output_file, ["Metric", "Value"], rows)


def save_history_csv(history: Dict[str, list], output_file: str) -> str:
    keys = list(history)
    n = len(history[keys[0]]) if keys else 0
    return _write_csv(output_file, ["epoch", *keys],
                      [[e + 1, *(history[k][e] for k in keys)]
                       for e in range(n)])


def plot_training_history(history: Dict[str, list], output_dir: str) -> str:
    """6-panel training-curve figure (loss / components / MPE / PCK / lr).
    Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    epochs = np.arange(1, len(history["train_loss"]) + 1)
    fig, axes = plt.subplots(2, 3, figsize=(20, 12))
    panels = [
        ("Total loss", [("train_loss", "train"), ("val_loss", "val")]),
        ("Loss components", [("train_position_loss", "position"),
                             ("train_bone_loss", "bone")]),
        ("MPE (m)", [("train_mpe", "train"), ("val_mpe", "val")]),
        ("PCK@0.2", [("train_pck", "train"), ("val_pck", "val")]),
        ("PCK@0.5", [("train_pck50", "train"), ("val_pck50", "val")]),
        ("Learning rate", [("lr", "lr")]),
    ]
    for ax, (title, series) in zip(axes.flat, panels):
        for key, label in series:
            if key in history and len(history[key]):
                ax.plot(epochs, history[key], label=label, linewidth=2)
        ax.set_title(title)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
        ax.legend()
        if title == "Learning rate":
            ax.set_yscale("log")
    fig.tight_layout()
    path = os.path.join(output_dir, "training_history.png")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def write_all_artifacts(result, output_dir: str,
                        keypoint_scale: float = 1000.0,
                        make_videos: bool = True,
                        max_video_frames: int = 720,
                        connections=None,
                        keypoint_names: Optional[Dict[int, str]] = None
                        ) -> Dict[str, str]:
    """Every artifact of a ``train/loop.py::TrainResult``
    (train.py:496-572); returns the written paths by kind."""
    os.makedirs(output_dir, exist_ok=True)
    paths = {}
    paths["predictions"] = save_all_predictions(
        result.targets, result.predictions,
        os.path.join(output_dir, "test_predictions.csv"), keypoint_scale)
    paths["error_stats"] = save_keypoint_errors(
        calculate_keypoint_errors(result.targets[:1000],
                                  result.predictions[:1000], keypoint_scale,
                                  names=keypoint_names),
        os.path.join(output_dir, "keypoint_error_stats.csv"))
    paths["summary"] = save_test_summary(
        result.test_metrics, os.path.join(output_dir,
                                          "test_results_summary.csv"))
    paths["history_csv"] = save_history_csv(
        result.history, os.path.join(output_dir, "training_history.csv"))
    try:
        paths["history_png"] = plot_training_history(result.history,
                                                     output_dir)
    except ImportError as e:
        print(f"[artifacts] skipped training_history.png: {e}")

    if make_videos:
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            print(f"[artifacts] skipped videos/true_poses.mp4, "
                  f"videos/predicted_poses.mp4, videos/comparison_poses.mp4: "
                  f"{e}")
            return paths
        from wiflow_tpu_torch.eval.video import (
            create_pose_animation, create_side_by_side_video,
        )
        conn = connections if connections is not None \
            else SKELETON_CONNECTIONS
        videos = os.path.join(output_dir, "videos")
        os.makedirs(videos, exist_ok=True)
        n = min(max_video_frames, len(result.predictions))
        # 3-D keypoints (MM-Fi) are drawn in the x/y plane
        t2 = result.targets[:n][..., :2]
        p2 = result.predictions[:n][..., :2]
        paths["video_true"] = create_pose_animation(
            t2, os.path.join(videos, "true_poses.mp4"), keypoint_scale,
            connections=conn)
        paths["video_pred"] = create_pose_animation(
            p2, os.path.join(videos, "predicted_poses.mp4"), keypoint_scale,
            connections=conn)
        paths["video_comparison"] = create_side_by_side_video(
            t2, p2, os.path.join(videos, "comparison_poses.mp4"),
            keypoint_scale, connections=conn)
    return paths
