"""Training engine: epochs, validation, LR plateau, early stop, test sweep.

Counterpart of ``wiflow_tpu/train/loop.py::train_pose_model`` (ref
train.py:48-580) on one CUDA device.  Kept from the reference: effective
batch = physical batch x grad accumulation, drop_last on train and on
val/test, val and test batch = batch // 2 (train.py:145), ReduceLROnPlateau
and early stop on the monitored val metric (MPE, or PCK for the MM-Fi
variant), the best weights kept on improvement and used for the test
sweep (PCK@{0.1..0.5} + MPJPE).

The splits are copied to the device once (the CSI in
``TrainConfig.data_dtype``); metrics reach the host once per epoch.  With
an ``output_dir`` the trainer writes ``best_pose_model.pth`` and
``.msgpack`` on every new best, and the resume bundle
``latest_checkpoint.pkl`` after every epoch when
``TrainConfig.checkpoint_every_epoch`` is set; ``resume=True`` continues
from that bundle.  Each epoch's randomness is drawn from generators seeded
with ``(seed, epoch)``, as the JAX package folds the epoch into its key:
the shuffle (a CPU generator), the model's ``dropout_generator`` and the
augmentation draws.  The bundle therefore holds no generator state, and a
run stopped after epoch k and resumed repeats the run that was never
stopped, bit for bit on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from wiflow_tpu_torch.core.checkpoint import (
    load_checkpoint, save_best_model, save_checkpoint,
)
from wiflow_tpu_torch.core.config import Config
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.models.wiflow_mmfi import WiFlowMMFiModel
from wiflow_tpu_torch.train.optim import (
    EarlyStopping, ReduceLROnPlateau, epoch_schedule_lr, get_learning_rate,
    set_learning_rate,
)
from wiflow_tpu_torch.train.steps import (
    TEST_THRESHOLDS, create_train_state, make_batch_indices, make_step_fns,
)

HISTORY_KEYS = (
    "train_loss", "val_loss", "train_position_loss", "train_bone_loss",
    "train_mpe", "val_mpe", "train_pck", "val_pck",
    "train_pck50", "val_pck50", "lr",
)
# The generators each epoch seeds from (seed, epoch, stream).
SHUFFLE, DROPOUT, AUGMENT = 0, 1, 2


def scaled_patience(epochs: int, steps: Optional[int],
                    steps_per_epoch: int) -> int:
    """Epoch-counted patience for a budget given in steps:
    ``max(epochs, ceil(steps / steps_per_epoch))``.  At the reference
    recipe's 3937 steps per epoch the defaults collapse to the raw epoch
    counts; ``steps`` None or 0 disables scaling."""
    if not steps:
        return epochs
    return max(epochs, -(-steps // steps_per_epoch))


def epoch_seed(seed: int, epoch: int, stream: int) -> int:
    """The seed of one generator of one epoch: a 64-bit hash of ``(seed,
    epoch, stream)``."""
    return int(np.random.SeedSequence([seed, epoch, stream])
               .generate_state(1, np.uint64)[0])


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
    # host-clock seconds of this call's epochs: each epoch's training
    # ('train_s'), of which the host spent 'enqueue_s' issuing the steps,
    # the whole epoch with validation ('epoch_s'), the bundle's write
    # ('bundle_s'), and each write of the best weights ('best_s')
    timings: Dict[str, list] = dataclasses.field(default_factory=dict)


def _stage(data: Tuple[np.ndarray, np.ndarray], device: torch.device,
           dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    x, y = data
    return (torch.as_tensor(np.asarray(x)).to(device, dtype),
            torch.as_tensor(np.asarray(y), dtype=torch.float32).to(device))


def _host(m: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in m.items()}


def train_pose_model(
    train_data: Tuple[np.ndarray, np.ndarray],
    val_data: Tuple[np.ndarray, np.ndarray],
    test_data: Tuple[np.ndarray, np.ndarray],
    cfg: Config = Config(),
    output_dir: Optional[str] = None,
    model: Optional[nn.Module] = None,
    resume: bool = True,
    connections=None,
    pck_fn=None,
    mpe_fn=None,
    loss_fn=None,
    to_keypoints=None,
    monitor: str = "mpe",
    init_state_dict: Optional[Dict[str, torch.Tensor]] = None,
    frozen_params: Sequence[str] = (),
    *,
    device=None,
    verbose: bool = True,
) -> TrainResult:
    """Train, validate with early stopping, then test with the best weights.

    Each split is ``(x [N, 540, 20], y [N, 15, 2])`` numpy arrays.
    ``output_dir``: where the best weights and the resume bundle go; None
    keeps everything in memory (no files, no resume).  ``model``: a module
    to train in place of ``WiFlowPoseModel(cfg.model)``, on its own device
    (``device`` is then ignored).  The hooks are ``make_step_fns``'s.
    ``monitor``: ``"mpe"`` (val MPE, mode min) or ``"pck"`` (val PCK@0.2,
    mode max).  ``init_state_dict``: entries of the model's ``state_dict``
    loaded over the fresh init (the JAX package's ``init_variables``).
    ``frozen_params``: top-level submodules left out of the optimization.
    ``device`` defaults to CUDA; pass ``"cpu"`` for the CPU.
    """
    t_start = time.time()
    tc = cfg.train
    if monitor not in ("mpe", "pck"):
        raise ValueError(f"monitor={monitor!r}: 'mpe' or 'pck'")
    mode = "min" if monitor == "mpe" else "max"
    if model is None:
        state = create_train_state(cfg.model, tc.optim, seed=tc.seed,
                                   device=device,
                                   frozen_params=frozen_params)
    else:
        state = create_train_state(optim=tc.optim, model=model,
                                   frozen_params=frozen_params)
    model = state.model
    dev = next(model.parameters()).device
    if init_state_dict:
        own = model.state_dict()
        unknown = sorted(set(init_state_dict) - set(own))
        if unknown:
            raise KeyError(f"init_state_dict entries not in the model: "
                           f"{unknown[:5]}")
        with torch.no_grad():
            for k, v in init_state_dict.items():
                own[k].copy_(torch.as_tensor(v))

    ddt = getattr(torch, tc.data_dtype)
    train_x, train_y = _stage(train_data, dev, ddt)
    val_x, val_y = _stage(val_data, dev, ddt)
    test_x, test_y = _stage(test_data, dev, ddt)
    n_train, n_val, n_test = len(train_x), len(val_x), len(test_x)

    batch = min(tc.batch_size, n_train)
    eval_batch = max(1, batch // 2)
    accum = max(1, tc.grad_accum_steps)
    train_epoch, eval_epoch = make_step_fns(
        tc.loss, use_augmentation=tc.use_augmentation,
        grad_accum_steps=accum, connections=connections, pck_fn=pck_fn,
        mpe_fn=mpe_fn, loss_fn=loss_fn, to_keypoints=to_keypoints)

    steps_per_epoch = max(1, (n_train // batch) // accum)
    scheduler = ReduceLROnPlateau.from_config(tc.optim, mode=mode)
    scheduler.patience = scaled_patience(tc.optim.plateau_patience,
                                         tc.optim.plateau_patience_steps,
                                         steps_per_epoch)
    stopper = EarlyStopping(patience=scaled_patience(
        tc.patience, tc.patience_steps, steps_per_epoch), mode=mode)
    if verbose and (scheduler.patience != tc.optim.plateau_patience
                    or stopper.patience != tc.patience):
        print(f"[patience] {steps_per_epoch} steps/epoch -> plateau "
              f"patience {scheduler.patience} epochs, early-stop "
              f"{stopper.patience} (steps-scaled)")
    history: Dict[str, list] = {k: [] for k in HISTORY_KEYS}
    timings: Dict[str, list] = {k: [] for k in (
        "epoch_s", "train_s", "enqueue_s", "bundle_s", "best_s")}
    best: Optional[Dict[str, torch.Tensor]] = None
    start_epoch = 0
    # the .msgpack needs the flax layout, which only the port's own
    # WiFlow modules have
    export_cfg = (model.config if isinstance(
        model, (WiFlowPoseModel, WiFlowMMFiModel)) else None)

    ckpt_path = (os.path.join(output_dir, "latest_checkpoint.pkl")
                 if output_dir else None)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    if ckpt_path and resume:
        ckpt = load_checkpoint(ckpt_path)
        if ckpt is not None:
            model.load_state_dict(ckpt["model"])
            state.optimizer.load_state_dict(ckpt["optimizer"])
            scheduler.load_state_dict(ckpt["scheduler"])
            stopper.load_state_dict(ckpt["early_stopping"])
            history = ckpt["history"]
            best = ckpt["best_state_dict"]
            start_epoch = ckpt["epoch"] + 1
            if verbose:
                print(f"[resume] continuing from epoch {start_epoch + 1} "
                      f"of {tc.num_epochs} (best val {monitor} "
                      f"{stopper.best:.4f} @ epoch {stopper.best_epoch + 1})")

    val_idx = make_batch_indices(n_val, eval_batch).to(dev)
    test_idx = make_batch_indices(n_test, eval_batch).to(dev)
    if verbose:
        print(f"[train] {n_train} samples, batch {batch} (accum {accum}), "
              f"{dev}, {tc.num_epochs} epochs")
        if n_val == 0 and start_epoch < tc.num_epochs:
            print("[train] WARNING: empty val split — early stopping, "
                  "plateau LR and the best weights follow the TRAIN-epoch "
                  "metrics")
    epochs_run = start_epoch
    dropout_gen = getattr(model, "dropout_generator", None)
    for epoch in range(start_epoch, tc.num_epochs):
        lr_used = get_learning_rate(state.optimizer)
        shuffle = torch.Generator().manual_seed(
            epoch_seed(tc.seed, epoch, SHUFFLE))
        perm = torch.randperm(n_train, generator=shuffle)
        batch_idx = make_batch_indices(n_train, batch, perm).to(dev)
        if dropout_gen is not None:
            dropout_gen.manual_seed(epoch_seed(tc.seed, epoch, DROPOUT))
        aug = None
        if tc.use_augmentation and epoch > 0:
            aug = torch.Generator(device=dev).manual_seed(
                epoch_seed(tc.seed, epoch, AUGMENT))

        t0 = time.time()
        tm = train_epoch(state, train_x, train_y, batch_idx, aug)
        t_enqueued = time.time()
        tm = _host(tm)
        t_trained = time.time()
        if n_val > 0:
            vm = _host(eval_epoch(model, val_x, val_y, val_idx)[0])
        else:
            vm = tm
        dt = time.time() - t0
        timings["epoch_s"].append(dt)
        timings["train_s"].append(t_trained - t0)
        timings["enqueue_s"].append(t_enqueued - t0)

        for split, m in (("train", tm), ("val", vm)):
            history[f"{split}_loss"].append(float(m["loss"]))
            history[f"{split}_mpe"].append(float(m["mpe"]))
            history[f"{split}_pck"].append(float(m["pck"]))
            history[f"{split}_pck50"].append(float(m["pck50"]))
        history["train_position_loss"].append(float(tm["position"]))
        history["train_bone_loss"].append(float(tm["bone"]))
        history["lr"].append(lr_used)

        val_mpe = float(vm["mpe"])
        monitored = val_mpe if monitor == "mpe" else float(vm["pck"])
        if verbose:
            print(f"Epoch {epoch + 1}/{tc.num_epochs} [{dt:.2f}s] "
                  f"train loss {float(tm['loss']):.4f} mpe "
                  f"{float(tm['mpe']):.4f} pck20 {float(tm['pck']):.4f} | "
                  f"val loss {float(vm['loss']):.4f} mpe {val_mpe:.4f} "
                  f"pck20 {float(vm['pck']):.4f} | lr {lr_used:.6f}")

        prev_lr = scheduler.lr
        if tc.optim.schedule == "plateau":
            new_lr = scheduler.step(monitored)
        else:
            new_lr = scheduler.lr = epoch_schedule_lr(tc.optim, epoch + 1)
        if new_lr != prev_lr:
            set_learning_rate(state.optimizer, new_lr)
            if verbose:
                print(f"  [plateau] lr -> {new_lr:.6f}")

        if stopper.update(monitored, epoch):
            best = {k: v.detach().clone()
                    for k, v in model.state_dict().items()}
            if output_dir:
                t_save = time.time()
                save_best_model(output_dir, best, export_cfg)
                timings["best_s"].append(time.time() - t_save)
            if verbose:
                print(f"  [best] val {monitor} {monitored:.4f}"
                      + (" -> saved best_pose_model.*" if output_dir else ""))

        epochs_run = epoch + 1
        if ckpt_path and tc.checkpoint_every_epoch:
            t_save = time.time()
            save_checkpoint(ckpt_path, {
                "model": model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": scheduler.state_dict(),
                "early_stopping": stopper.state_dict(),
                "history": history,
                "best_state_dict": best,
                "epoch": epoch,
            })
            timings["bundle_s"].append(time.time() - t_save)

        if stopper.should_stop:
            if verbose:
                print(f"[early-stop] after epoch {epoch + 1}; best epoch "
                      f"{stopper.best_epoch + 1}")
            break

    if best is not None:
        model.load_state_dict(best)
    test_m, (preds, targets) = eval_epoch(model, test_x, test_y, test_idx)
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
        wall_clock_sec=time.time() - t_start, timings=timings)
