"""The noise-robustness sweep.

Counterpart of ``wiflow_tpu/robustness/evaluate.py`` (ref cross_dataset_test/
HPE-Li/main.py:52-105): for each noise level, corrupt the CSI on the host
(the numpy noise functions, so one seed gives the JAX package's bytes),
optionally clean it with a traditional filter on the device (mode 2) and/or
a denoiser (mode 1), predict, and score PCK, MPJPE and PA-MPJPE with the
port's metrics.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from wiflow_tpu_torch.core.config import resolve_device
from wiflow_tpu_torch.metrics.metrics import mpjpe, pck_correct_fractions
from wiflow_tpu_torch.metrics.mmfi_metrics import pa_mpjpe
from wiflow_tpu_torch.robustness.filters import gaussian_filter, mean_filter
from wiflow_tpu_torch.robustness.noise import (
    add_awgn, add_salt_and_pepper_noise,
)

FILTERS = {"gaussian": gaussian_filter, "mean": mean_filter,
           "none": lambda x: x}
NOISES = {"awgn": add_awgn, "salt_pepper": add_salt_and_pepper_noise}
THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5)


def evaluate_robustness(
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    csi: np.ndarray,
    keypoints: np.ndarray,
    noise_levels: Sequence[float] = (0.0, 0.1, 0.2, 0.4),
    noise_kind: str = "awgn",
    cleaner: str = "none",
    denoise_fn: Optional[Callable] = None,
    pck_fn=None,
    batch_size: int = 256,
    seed: int = 0,
    *,
    device=None,
) -> Dict[float, Dict[str, float]]:
    """Returns ``{noise_level: {'pck@t': ..., 'mpjpe': ..., 'pa_mpjpe':
    ...}}``.

    ``predict_fn`` maps an fp32 CSI batch on ``device`` (CUDA unless
    ``"cpu"``) to keypoints; ``denoise_fn`` (mode 1) maps corrupted CSI to
    cleaned CSI there; ``cleaner`` picks a traditional filter (mode 2),
    applied on the device to the batch as ``[B, C, S, T]``.  The batches
    are ``csi``'s in order, the last partial one dropped; the noise is
    drawn on the host from ``np.random.default_rng(seed)``.
    """
    dev = resolve_device(device)
    pck_fn = pck_fn or pck_correct_fractions
    noise = NOISES[noise_kind]
    filt = FILTERS[cleaner]
    rng = np.random.default_rng(seed)
    results: Dict[float, Dict[str, float]] = {}
    for level in noise_levels:
        preds = []
        for i in range(0, len(csi) - batch_size + 1, batch_size):
            xb = csi[i:i + batch_size]
            if level > 0:
                xb = noise(xb, level, rng)
            x = torch.as_tensor(np.asarray(xb)).to(dev, torch.float32)
            if cleaner != "none":
                shaped = x if x.ndim == 4 else x[:, None]
                x = filt(shaped).reshape(x.shape)
            if denoise_fn is not None:
                x = denoise_fn(x)
            preds.append(predict_fn(x))
        pred = torch.cat(preds).float()
        target = torch.as_tensor(keypoints[: len(pred)]).to(dev,
                                                            torch.float32)
        fr = pck_fn(pred, target, THRESHOLDS).tolist()
        row = {f"pck@{t}": float(v) for t, v in zip(THRESHOLDS, fr)}
        row["mpjpe"] = float(mpjpe(pred, target))
        if pred.shape[-1] >= 2:
            row["pa_mpjpe"] = float(pa_mpjpe(pred, target))
        results[level] = row
    return results
