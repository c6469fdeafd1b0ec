"""Skeleton video rendering with direct OpenCV drawing.

A copy of ``wiflow_tpu/eval/video.py`` (in place of ref
visualization/pose_viz.py:13-106, which rasterizes a matplotlib figure per
frame): lines and circles drawn straight onto numpy canvases.  OpenCV is
imported inside the functions, so the module imports without it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from wiflow_tpu_torch.core.config import KEYPOINT_NAMES, SKELETON_CONNECTIONS

# BGR colors per body part (our own palette; the reference's is undefined)
_PART_COLORS = {
    "head": (0, 215, 255),
    "torso": (180, 180, 180),
    "left_arm": (80, 200, 80),
    "right_arm": (220, 120, 60),
    "left_leg": (90, 90, 230),
    "right_leg": (200, 80, 200),
}
_KP_PART = {0: "head", 1: "torso", 8: "torso",
            2: "left_arm", 3: "left_arm", 4: "left_arm",
            5: "right_arm", 6: "right_arm", 7: "right_arm",
            9: "left_leg", 10: "left_leg", 11: "left_leg",
            12: "right_leg", 13: "right_leg", 14: "right_leg"}


def _fit_transform(kp: np.ndarray, size: Tuple[int, int], margin: int = 60):
    """Map a [N, K, 2] sequence's global bbox into pixel coordinates."""
    w, h = size
    lo = kp.reshape(-1, 2).min(axis=0)
    hi = kp.reshape(-1, 2).max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = min((w - 2 * margin) / span[0], (h - 2 * margin) / span[1])

    def to_px(points: np.ndarray) -> np.ndarray:
        xy = (points - lo) * scale
        xy[:, 0] += margin
        xy[:, 1] += margin
        return xy.astype(np.int32)

    return to_px


def _draw_skeleton(canvas: np.ndarray, pts: np.ndarray,
                   connections=SKELETON_CONNECTIONS,
                   show_labels: bool = False) -> None:
    import cv2

    for s, e in connections:
        if s < len(pts) and e < len(pts):
            color = _PART_COLORS.get(_KP_PART.get(e, "torso"), (255, 255, 255))
            cv2.line(canvas, tuple(pts[s]), tuple(pts[e]), color, 2,
                     cv2.LINE_AA)
    for i, p in enumerate(pts):
        color = _PART_COLORS.get(_KP_PART.get(i, "torso"), (255, 255, 255))
        cv2.circle(canvas, tuple(p), 4, color, -1, cv2.LINE_AA)
        if show_labels:
            cv2.putText(canvas, KEYPOINT_NAMES.get(i, str(i)),
                        (p[0] + 5, p[1] - 5), cv2.FONT_HERSHEY_SIMPLEX,
                        0.35, (200, 200, 200), 1, cv2.LINE_AA)


def create_pose_animation(keypoints: np.ndarray, output_file: str,
                          keypoint_scale: float = 1000.0, fps: int = 30,
                          size: Tuple[int, int] = (640, 640),
                          show_labels: bool = True,
                          connections=SKELETON_CONNECTIONS) -> str:
    """Single-skeleton animation of a [N, K, 2] sequence."""
    import cv2

    kp = np.asarray(keypoints, np.float64)
    kp = kp.reshape(len(kp), -1, kp.shape[-1] if kp.ndim == 3 else 2)
    kp = kp[..., :2] * keypoint_scale
    to_px = _fit_transform(kp, size)
    writer = cv2.VideoWriter(output_file,
                             cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    try:
        for frame in kp:
            canvas = np.full((size[1], size[0], 3), 16, np.uint8)
            _draw_skeleton(canvas, to_px(frame.copy()), connections,
                           show_labels)
            writer.write(canvas)
    finally:
        writer.release()
    return output_file


def create_side_by_side_video(true_kp: np.ndarray, pred_kp: np.ndarray,
                              output_file: str,
                              keypoint_scale: float = 1000.0, fps: int = 30,
                              panel: Tuple[int, int] = (480, 560),
                              connections=SKELETON_CONNECTIONS) -> str:
    """Ground-truth vs prediction, two panels per frame
    (ref pose_viz.py:13-106)."""
    import cv2

    n = min(len(true_kp), len(pred_kp))
    t = np.asarray(true_kp[:n], np.float64)
    t = t.reshape(n, -1, t.shape[-1] if t.ndim == 3 else 2)[..., :2] * keypoint_scale
    p = np.asarray(pred_kp[:n], np.float64)
    p = p.reshape(n, -1, p.shape[-1] if p.ndim == 3 else 2)[..., :2] * keypoint_scale
    to_px = _fit_transform(np.concatenate([t, p]), panel)

    size = (panel[0] * 2, panel[1])
    writer = cv2.VideoWriter(output_file,
                             cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    try:
        for i in range(n):
            left = np.full((panel[1], panel[0], 3), 16, np.uint8)
            right = left.copy()
            _draw_skeleton(left, to_px(t[i].copy()), connections)
            _draw_skeleton(right, to_px(p[i].copy()), connections)
            cv2.putText(left, "ground truth", (10, 24),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 1)
            cv2.putText(right, f"prediction  frame {i}", (10, 24),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 1)
            writer.write(np.concatenate([left, right], axis=1))
    finally:
        writer.release()
    return output_file
