"""Training engine: epochs, validation, LR plateau, early stop, test sweep.

Counterpart of ``wiflow_tpu/train/loop.py::train_pose_model`` (ref
train.py:48-580) on one CUDA device.  Kept from the reference: effective
batch = physical batch x grad accumulation, drop_last on train and on
val/test, val and test batch = batch // 2 (train.py:145), ReduceLROnPlateau
on val MPE, early stop on val MPE, the best weights kept on val-MPE
improvement and used for the test sweep (PCK@{0.1..0.5} + MPJPE).

The splits are copied to the device once; each epoch's shuffle comes from
a CPU ``torch.Generator`` seeded with ``TrainConfig.seed``.  Metrics reach
the host once per epoch.  Checkpoint files, resume and artifacts are not
ported yet: the best weights are kept in memory and returned.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wiflow_tpu_torch.core.config import Config, resolve_device
from wiflow_tpu_torch.train.optim import (
    EarlyStopping, ReduceLROnPlateau, epoch_schedule_lr, get_learning_rate,
    set_learning_rate,
)
from wiflow_tpu_torch.train.steps import (
    TEST_THRESHOLDS, create_train_state, eval_epoch, make_batch_indices,
    train_epoch,
)

HISTORY_KEYS = (
    "train_loss", "val_loss", "train_position_loss", "train_bone_loss",
    "train_mpe", "val_mpe", "train_pck", "val_pck",
    "train_pck50", "val_pck50", "lr",
)


def scaled_patience(epochs: int, steps: Optional[int],
                    steps_per_epoch: int) -> int:
    """Epoch-counted patience for a budget given in steps:
    ``max(epochs, ceil(steps / steps_per_epoch))``.  At the reference
    recipe's 3937 steps per epoch the defaults collapse to the raw epoch
    counts; ``steps`` None or 0 disables scaling."""
    if not steps:
        return epochs
    return max(epochs, -(-steps // steps_per_epoch))


@dataclasses.dataclass
class TrainResult:
    state_dict: Dict[str, torch.Tensor]   # best weights, on the CPU
    history: Dict[str, list]
    test_metrics: Dict[str, float]        # loss, mpe, pck@0.1..0.5
    predictions: np.ndarray               # [n_test_eval, K, D]
    targets: np.ndarray
    best_epoch: int
    epochs_run: int
    wall_clock_sec: float


def _stage(data: Tuple[np.ndarray, np.ndarray], device: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    x, y = data
    return (torch.as_tensor(np.asarray(x), dtype=torch.float32).to(device),
            torch.as_tensor(np.asarray(y), dtype=torch.float32).to(device))


def _host(m: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in m.items()}


def train_pose_model(train_data: Tuple[np.ndarray, np.ndarray],
                     val_data: Tuple[np.ndarray, np.ndarray],
                     test_data: Tuple[np.ndarray, np.ndarray],
                     cfg: Config = Config(), *, device=None,
                     verbose: bool = True) -> TrainResult:
    """Train, validate with early stopping, then test with the best weights.

    Each split is ``(x [N, 540, 20], y [N, 15, 2])`` numpy arrays.
    ``device`` defaults to CUDA; pass ``"cpu"`` for the CPU.
    """
    t_start = time.time()
    tc = cfg.train
    dev = resolve_device(device)
    state = create_train_state(cfg.model, tc.optim, seed=tc.seed, device=dev)
    model = state.model

    train_x, train_y = _stage(train_data, dev)
    val_x, val_y = _stage(val_data, dev)
    test_x, test_y = _stage(test_data, dev)
    n_train, n_val, n_test = len(train_x), len(val_x), len(test_x)

    batch = min(tc.batch_size, n_train)
    eval_batch = max(1, batch // 2)
    accum = max(1, tc.grad_accum_steps)
    steps_per_epoch = max(1, (n_train // batch) // accum)
    scheduler = ReduceLROnPlateau.from_config(tc.optim)
    scheduler.patience = scaled_patience(tc.optim.plateau_patience,
                                         tc.optim.plateau_patience_steps,
                                         steps_per_epoch)
    stopper = EarlyStopping(patience=scaled_patience(
        tc.patience, tc.patience_steps, steps_per_epoch))
    if verbose and (scheduler.patience != tc.optim.plateau_patience
                    or stopper.patience != tc.patience):
        print(f"[patience] {steps_per_epoch} steps/epoch -> plateau "
              f"patience {scheduler.patience} epochs, early-stop "
              f"{stopper.patience} (steps-scaled)")
    history: Dict[str, list] = {k: [] for k in HISTORY_KEYS}
    best: Optional[Dict[str, torch.Tensor]] = None
    shuffle = torch.Generator().manual_seed(tc.seed)
    val_idx = make_batch_indices(n_val, eval_batch).to(dev)
    test_idx = make_batch_indices(n_test, eval_batch).to(dev)

    if verbose:
        print(f"[train] {n_train} samples, batch {batch} (accum {accum}), "
              f"{dev}, {tc.num_epochs} epochs")
        if n_val == 0:
            print("[train] WARNING: empty val split — early stopping, "
                  "plateau LR and the best weights follow the TRAIN-epoch "
                  "metrics")
    epochs_run = 0
    for epoch in range(tc.num_epochs):
        lr_used = get_learning_rate(state.optimizer)
        perm = torch.randperm(n_train, generator=shuffle)
        batch_idx = make_batch_indices(n_train, batch, perm).to(dev)
        t0 = time.time()
        tm = _host(train_epoch(state, train_x, train_y, batch_idx, tc.loss,
                               accum))
        if n_val > 0:
            vm = _host(eval_epoch(model, val_x, val_y, val_idx, tc.loss)[0])
        else:
            vm = tm
        dt = time.time() - t0

        for split, m in (("train", tm), ("val", vm)):
            history[f"{split}_loss"].append(float(m["loss"]))
            history[f"{split}_mpe"].append(float(m["mpe"]))
            history[f"{split}_pck"].append(float(m["pck"]))
            history[f"{split}_pck50"].append(float(m["pck50"]))
        history["train_position_loss"].append(float(tm["position"]))
        history["train_bone_loss"].append(float(tm["bone"]))
        history["lr"].append(lr_used)

        val_mpe = float(vm["mpe"])
        if verbose:
            print(f"Epoch {epoch + 1}/{tc.num_epochs} [{dt:.2f}s] "
                  f"train loss {float(tm['loss']):.4f} mpe "
                  f"{float(tm['mpe']):.4f} pck20 {float(tm['pck']):.4f} | "
                  f"val loss {float(vm['loss']):.4f} mpe {val_mpe:.4f} "
                  f"pck20 {float(vm['pck']):.4f} | lr {lr_used:.6f}")

        prev_lr = scheduler.lr
        if tc.optim.schedule == "plateau":
            new_lr = scheduler.step(val_mpe)
        else:
            new_lr = scheduler.lr = epoch_schedule_lr(tc.optim, epoch + 1)
        if new_lr != prev_lr:
            set_learning_rate(state.optimizer, new_lr)
            if verbose:
                print(f"  [plateau] lr -> {new_lr:.6f}")

        if stopper.update(val_mpe, epoch):
            best = {k: v.detach().clone()
                    for k, v in model.state_dict().items()}
            if verbose:
                print(f"  [best] val mpe {val_mpe:.4f}")
        epochs_run = epoch + 1
        if stopper.should_stop:
            if verbose:
                print(f"[early-stop] after epoch {epoch + 1}; best epoch "
                      f"{stopper.best_epoch + 1}")
            break

    if best is not None:
        model.load_state_dict(best)
    test_m, (preds, targets) = eval_epoch(model, test_x, test_y, test_idx,
                                          tc.loss)
    test_m = _host(test_m)
    test_metrics = {"loss": float(test_m["loss"]),
                    "mpe": float(test_m["mpe"])}
    for thr, v in zip(TEST_THRESHOLDS, test_m["pck_curve"]):
        test_metrics[f"pck@{thr}"] = float(v)
    if verbose:
        pcks = " ".join(f"PCK@{int(t * 100)}="
                        f"{test_metrics[f'pck@{t}'] * 100:.2f}%"
                        for t in TEST_THRESHOLDS)
        print(f"[test] loss {test_metrics['loss']:.4f} "
              f"MPJPE {test_metrics['mpe']:.4f} m | {pcks}")
    return TrainResult(
        state_dict={k: v.detach().cpu() for k, v in model.state_dict().items()},
        history=history, test_metrics=test_metrics,
        predictions=preds.cpu().numpy(), targets=targets.cpu().numpy(),
        best_epoch=stopper.best_epoch, epochs_run=epochs_run,
        wall_clock_sec=time.time() - t_start)
