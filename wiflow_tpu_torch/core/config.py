"""Configuration of the port: data, model, loss, optimizer and training run.

A copy of the fields of ``wiflow_tpu.core.config`` that the port reads,
with the same defaults (the reference architecture and trainer, ref
models/pose_model.py:16-53 and train.py:105-121).  The JAX package's
config module is not imported: importing anything under ``wiflow_tpu``
runs its package ``__init__``, which loads JAX.  Of the config's lowering
switches only ``tcn_train_impl`` and ``conv_train_impl`` have a
counterpart: they select the stage-fused train path
(``ops/kernels/stage_fused.py``).  The ablation switches ``tcn_conv``
(``grouped``, ``plain`` or ``depthwise`` TCN convs), ``encoder_kind``
(``wiflow`` or the ``conv2d`` residual encoder) and ``use_attention``
shape the module (``models/wiflow.py``); the serving kernels of
``models/fast.py`` take only the default architecture.  The serving
path's choice of attention kernel is, as in the reference, not a config
field but the
``attention_impl`` argument of ``models/fast.py::fast_forward`` (``"v2"``,
``"dual"`` or ``"v1"``).  The others (``attention_module_impl``,
``rng_impl``, ``scan_epochs``,
``max_steps_per_call``, ``tcn_matmul``) are TPU matters and have none.
``MeshConfig`` is the data-parallel layout (``parallel/mesh.py``): one
process a rank, a CUDA device each.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

# 14-edge skeleton over the 15 retained OpenPose keypoints
# (ref config.py:30-34 and losses/pose_loss.py:20-24).
SKELETON_CONNECTIONS: Tuple[Tuple[int, int], ...] = (
    (0, 1), (1, 8), (1, 2), (2, 3), (3, 4),
    (1, 5), (5, 6), (6, 7), (8, 9), (8, 12),
    (9, 10), (10, 11), (12, 13), (13, 14),
)

# Keypoint index -> name (ref config.py:37-41).
KEYPOINT_NAMES = {
    0: "Neck", 1: "Chest", 2: "L_Shoulder", 3: "L_Elbow", 4: "L_Wrist",
    5: "R_Shoulder", 6: "R_Elbow", 7: "R_Wrist", 8: "Pelvis", 9: "L_Hip",
    10: "L_Knee", 11: "L_Ankle", 12: "R_Hip", 13: "R_Knee", 14: "R_Ankle",
}


# MM-Fi 17-keypoint skeleton: spine and head, legs from the bottom of the
# torso, arms from the base of the neck (ref cross_dataset_test/WiFlow/
# wiflow.py:544-551).
MMFI_SKELETON_CONNECTIONS: Tuple[Tuple[int, int], ...] = (
    (0, 7), (7, 8), (8, 9), (9, 10),
    (0, 1), (1, 2), (2, 3),
    (0, 4), (4, 5), (5, 6),
    (9, 14), (14, 15), (15, 16),
    (9, 11), (11, 12), (12, 13),
)


TRAIN_IMPLS = ("xla", "fused", "auto")
TCN_CONVS = ("grouped", "plain", "depthwise")
ENCODER_KINDS = ("wiflow", "conv2d")


def tcn_conv_groups(tcn_conv: str, groups: int, channels: int) -> int:
    """Groups of a TCN k=3 conv over ``channels`` under the ``tcn_conv``
    switch: ``groups`` for ``"grouped"``, 1 for ``"plain"``, ``channels``
    for ``"depthwise"`` (``wiflow_tpu/models/wiflow.py::TCNLevel._groups``)."""
    if tcn_conv not in TCN_CONVS:
        raise ValueError(f"tcn_conv={tcn_conv!r}: one of {TCN_CONVS}")
    return {"grouped": groups, "plain": 1, "depthwise": channels}[tcn_conv]


def use_fused(impl: str, device: torch.device) -> bool:
    """Whether a ``*_train_impl`` switch selects the fused train path for
    a model on ``device``."""
    if impl not in TRAIN_IMPLS:
        raise ValueError(f"train impl {impl!r}: one of {TRAIN_IMPLS}")
    return impl == "fused" or (impl == "auto" and device.type == "cuda")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset and preprocessing contract (ref dataset.py)."""

    data_dir: str = "preprocessed_csi_data"
    keypoint_scale: float = 1000.0
    window_size: int = 20
    stride: int = 1
    num_keypoints: int = 15
    num_subcarriers: int = 540
    enable_temporal_clean: bool = True      # zero-keypoint repair
    # file-level random split ratios (ref dataset.py:269-276)
    train_ratio: float = 0.7
    val_ratio: float = 0.15
    split_seed: int = 42


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """WiFlow model hyperparameters."""

    num_subcarriers: int = 540
    window_size: int = 20
    num_keypoints: int = 15
    keypoint_dims: int = 2
    tcn_channels: Sequence[int] = (540, 440, 340, 240)
    tcn_kernel_size: int = 3
    tcn_groups: int = 20
    conv_channels: Sequence[int] = (8, 16, 32, 64)
    attention_groups: int = 8
    dropout: float = 0.5                    # TCN levels (ref train.py:88)
    conv_dropout: float = 0.3               # conv blocks' Dropout2d
    # compute dtype for the forward pass; parameters stay fp32
    compute_dtype: str = "bfloat16"
    # Train-mode lowering of the TCN and of the conv stack: 'xla' = stock
    # torch ops (the name is the JAX package's, so that its configs carry
    # over), 'fused' = one stage kernel per BN-apply -> SiLU -> dropout ->
    # conv and one join kernel per residual tail
    # (ops/kernels/stage_fused.py), 'auto' = fused on a CUDA device.  Eval
    # mode ignores both.
    tcn_train_impl: str = "xla"
    conv_train_impl: str = "xla"
    # ablation switches (ref README.md:240-248): the TCN's k=3 convs
    # 'grouped' (tcn_groups), 'plain' (one group) or 'depthwise' (a group
    # a channel); the encoder 'wiflow' (TCN + (1,3) conv stack) or
    # 'conv2d' (a pointwise projection and symmetric 3x3 residual blocks);
    # the dual axial attention on or off
    tcn_conv: str = "grouped"
    encoder_kind: str = "wiflow"
    use_attention: bool = True

    def __post_init__(self):
        for name, allowed in (("tcn_train_impl", TRAIN_IMPLS),
                              ("conv_train_impl", TRAIN_IMPLS),
                              ("tcn_conv", TCN_CONVS),
                              ("encoder_kind", ENCODER_KINDS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: one of "
                                 f"{allowed}")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Pose loss (ref losses/pose_loss.py:8-17, train.py:99-103)."""

    position_weight: float = 1.0
    bone_weight: float = 0.2
    loss_type: str = "smooth_l1"            # 'mse' | 'l1' | 'smooth_l1'
    position_beta: float = 0.1
    bone_beta: float = 0.05


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """AdamW, global-norm clip and the LR schedules (ref train.py:105-121).

    ``kind``: 'adamw' (the trunk), 'adam' (WiSPPN, PerUnet) or 'sgd' with
    ``momentum`` (WPformer 0.9; HPE-Li plain SGD: momentum 0, no clip).
    The plateau scheduler follows torch's
    ``ReduceLROnPlateau``; its patience, like the early stop's, may be
    given in optimizer steps (``plateau_patience_steps``), see
    ``train/loop.py::scaled_patience``.
    """

    lr: float = 1e-4
    weight_decay: float = 5e-5
    betas: Tuple[float, float] = (0.9, 0.999)
    grad_clip_norm: Optional[float] = 1.0   # None or <= 0: no clipping
    kind: str = "adamw"
    momentum: float = 0.9
    schedule: str = "plateau"               # | 'linear_decay' | 'multistep'
    decay_start: int = 20
    decay_end: int = 50
    milestones: Tuple[int, ...] = (20, 40)
    gamma: float = 0.1
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    plateau_threshold: float = 1e-4         # threshold_mode 'rel'
    plateau_cooldown: int = 1
    min_lr_ratio: float = 1e-3              # min_lr = lr / 1000
    # 252k train windows / batch 64 = 3937 steps per epoch, x3 epochs
    plateau_patience_steps: Optional[int] = 3 * 3937


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training run (ref config.py:18-19, train.py:145,382)."""

    batch_size: int = 64
    grad_accum_steps: int = 1               # effective = batch * accum
    num_epochs: int = 50
    patience: int = 5                       # early stop on val MPE
    patience_steps: Optional[int] = 5 * 3937
    # subcarrier masking, noise and scaling from the second epoch on
    # (ref train.py:187-193)
    use_augmentation: bool = False
    seed: int = 42
    # val/test batches are batch // 2 and drop the last partial batch
    drop_last_eval: bool = True
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    # storage dtype of the staged CSI on the device (labels stay fp32):
    # 'float32' or 'bfloat16', which halves its memory
    data_dtype: str = "float32"
    # write the resume bundle latest_checkpoint.pkl after every epoch
    checkpoint_every_epoch: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Data-parallel layout: ``num_devices`` ranks, each a process on a
    device of its own (``parallel/mesh.py``).  None: every CUDA device
    where a CLI starts the ranks, one process on the CPU; a trainer run
    outside a process group takes None as its one process.  The JAX
    field ``data_axis`` names a mesh axis, which a torch process group
    does not have."""

    num_devices: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    output_dir: str = "outputs"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``device=None`` means ``"cuda"``.  Without a usable CUDA device this
    raises instead of dropping to the CPU; the CPU is used only when the
    caller passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wiflow_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def exact_fp32() -> None:
    """Full-precision fp32 products and convolutions on the card: no TF32
    (which cuDNN takes for fp32 convolutions by default).  The JAX
    baselines convolve at ``Precision.HIGHEST``; the entry points that
    train a baseline call this.  bf16 work is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_constant(values, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """A small constant (indices, thresholds) on ``device`` without a host
    sync: ``torch.tensor(values, device="cuda")`` copies from pageable
    memory and waits for the stream, so on CUDA the values go through
    pinned memory and an asynchronous copy."""
    t = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t
