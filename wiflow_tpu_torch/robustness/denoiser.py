"""Stacked denoising autoencoders for CSI (the HPE-Li robustness pipeline).

Counterpart of ``wiflow_tpu/robustness/denoiser.py`` (ref cross_dataset_test/
HPE-Li/model/HPE_{one..five}_denoiser.py and denoiser_training.py): a greedy
stack of conv autoencoder stages with the reference's shapes

  stage 1: 3->16  conv3x3+BN+ReLU+maxpool2   (HPE_one_denoiser.py:16-21)
  stage 2: 16->32 conv3x3+BN+ReLU+maxpool2   (HPE_two_denoiser.py:17-22)
  stage 3: 32->32 conv3x3+BN+ReLU+maxpool2   (HPE_three_denoiser.py:18-21)
  stage 4: 32->64 conv3x3+BN+ReLU (no pool)  (HPE_four_denoiser.py:17-19)
  stage 5: 64->64 conv3x3+BN+ReLU (no pool)  (HPE_five_denoiser.py:16-20)

and decoders ConvTranspose2d(cout, cout, 2, 2) + BN + ReLU +
ConvTranspose2d(cout, cin, 3, 1, 1); stages from the second on resize the
decoded map back to the stage's input size (``F.interpolate`` bilinear,
``align_corners=False``, no antialiasing, as ``jax.image.resize`` with
``antialias=False``).

The modules are NCHW, as the reference's (the JAX package runs the stages
channel-last); :func:`train_denoiser_stage` takes NCHW data.  Names are the
reference's: an :class:`AEStage` holds ``encoder.{0,1}`` and
``decoder.{0,1,3}`` (``*StageAE``), a :class:`DenoiserHPE` the encoders in
the nested ``getEncoder()`` chain (``encoder.0.0.1.0.weight`` ...), its
SKUnits and its regression head (``*LayerDenoiserHPE``).  Each has a
``spec()`` (this module's copy of the JAX package's spec functions,
``denoiser.py:301-369``), which ``models/baselines/hpeli_zoo.py``'s
``state_dict_from_spec`` / ``variables_from_spec`` apply.

The training quirk is kept (denoiser_training.py:61-82): the
reconstruction target is the corrupted code itself, so the "denoising" AE
trains as a plain autoencoder of corrupted codes; ``target='clean'`` trains
the denoising objective instead.  A DenoiserHPE fine-tunes its encoder
together with the head, as the reference does (main.py:65-67);
``frozen_params=("encoder",)`` in ``train/loop.py::train_pose_model``
freezes it instead.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wiflow_tpu_torch.core.config import resolve_device
from wiflow_tpu_torch.models.baselines.hpeli_zoo import (
    ReferenceLayout, SKUnitSelective, Spec, _hwio, _hwio_inv, _ident,
    avg_pool_nchw, bn_specs, regression_spec, sk_unit_selective_spec,
    torch_init_,
)
from wiflow_tpu_torch.models.baselines.sknet_trans import RegressionHead
from wiflow_tpu_torch.models.layers import ChannelFirstBatchNorm

# per-stage (cin, cout, maxpool), see the module docstring
STAGE_CHANNELS: Tuple[Tuple[int, int, bool], ...] = (
    (3, 16, True), (16, 32, True), (32, 32, True),
    (32, 64, False), (64, 64, False),
)


class _Conv3x3(nn.Conv2d):
    """The encoder's 3x3 conv (pad 1) with the JAX package's dtype rule:
    the product in the input's dtype, the fp32 bias added after it (so a
    bf16 input gives an fp32 output)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), padding=1)
        return y + self.bias[None, :, None, None]


class AEStage(ReferenceLayout, nn.Module):
    """One reference AE stage, NCHW: ``encoder`` = conv3x3 + BN + ReLU
    (+ maxpool2), ``decoder`` = ConvTranspose2d(k2, s2) + BN + ReLU +
    ConvTranspose2d(k3, p1) (weights in torch's ``[cin, cout, kh, kw]``).
    ``resize_decode``: stages from the second on resize the decoded map
    back to the stage input's size."""

    def __init__(self, cin: int, cout: int, pool: bool = True,
                 resize_decode: bool = True, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.resize_decode = resize_decode
        enc = [torch_init_(_Conv3x3(cin, cout, 3, padding=1, device=device),
                           generator),
               ChannelFirstBatchNorm(cout, device=device), nn.ReLU()]
        if pool:
            enc.append(nn.MaxPool2d(2))
        self.encoder = nn.Sequential(*enc)
        self.decoder = nn.Sequential(
            torch_init_(nn.ConvTranspose2d(cout, cout, 2, stride=2,
                                           device=device), generator),
            ChannelFirstBatchNorm(cout, device=device), nn.ReLU(),
            torch_init_(nn.ConvTranspose2d(cout, cin, 3, stride=1, padding=1,
                                           device=device), generator))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, z: torch.Tensor,
               out_hw: Optional[Sequence[int]] = None) -> torch.Tensor:
        y = self.decoder(z)
        if self.resize_decode and out_hw is not None:
            y = F.interpolate(y, size=tuple(out_hw), mode="bilinear",
                              align_corners=False, antialias=False)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x), out_hw=x.shape[2:])

    def spec(self) -> List[Spec]:
        return ae_stage_specs()


class StackedDenoisingAE(ReferenceLayout, nn.Module):
    """``num_stages`` greedy AE stages, ``stages.{i}`` (the JAX package's
    ``stage_{i}``); ``encode`` runs the stack (the reference AEs'
    ``getEncoder()`` chain).  Built on ``device`` (CUDA unless ``"cpu"``),
    its weights drawn from ``generator`` (seed 0 when None)."""

    def __init__(self, num_stages: int = 1, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.num_stages = num_stages
        self.stages = nn.ModuleList(
            AEStage(cin, cout, pool, resize_decode=i > 0, generator=gen,
                    device=dev)
            for i, (cin, cout, pool) in enumerate(STAGE_CHANNELS[:num_stages]))

    def encode(self, x: torch.Tensor, upto: Optional[int] = None
               ) -> torch.Tensor:
        for stage in self.stages[:upto]:
            x = stage.encode(x)
        return x

    def autoencode_last(self, code: torch.Tensor) -> torch.Tensor:
        """The last stage's encoder and decoder on a code: the reference's
        ``model(csi_data)`` in denoiser_training.py:78, whose input is
        already the frozen prefix's code."""
        return self.stages[-1](code)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """From raw input: encode through the prefix, then autoencode with
        the last stage (the output lives in the previous stage's code
        space; raw space for one stage)."""
        return self.autoencode_last(self.encode(x, upto=self.num_stages - 1))

    def spec(self) -> List[Spec]:
        return [s for i in range(self.num_stages)
                for s in ae_stage_specs((f"stage_{i}",), f"stages.{i}.")]


def train_denoiser_stage(
    clean: np.ndarray,
    num_stages: int,
    noise_fn,
    prev_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    *,
    epochs: int = 5,
    batch_size: int = 32,
    lr: float = 1e-3,
    seed: int = 0,
    target: str = "noisy",
    verbose: bool = False,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Greedy training of stage ``num_stages`` on NCHW ``clean`` data
    (numpy or a tensor; it goes to ``device`` once).

    ``noise_fn(code, generator) -> corrupted`` runs on the device on each
    batch's frozen-prefix code (the reference corrupts the
    ``getProcessingInput`` output, denoiser_training.py:63-70), drawing from
    a ``torch.Generator`` on the device seeded with ``seed``.  The earlier
    stages come from ``prev_state_dict`` (the result of the previous call),
    run in eval mode and are left out of the optimization: they come back
    unchanged bit for bit (the reference runs its prefix in train mode,
    which drifts its BN statistics while optimizing nothing; neither
    package replicates that drift).  Adam at ``lr`` on the last stage's
    parameters; each epoch's batches are ``np.random.default_rng(seed)``'s
    next permutation, the last partial batch dropped.

    ``target='noisy'`` is the reference's loss, ``criterion(reconstructed,
    csi_data)`` where ``csi_data`` is the corrupted tensor; ``'clean'``
    trains the denoising objective.  Returns the ``StackedDenoisingAE``'s
    ``state_dict`` (on the device).  ``device`` defaults to CUDA.
    """
    if target not in ("noisy", "clean"):
        raise ValueError(f"target must be 'noisy' or 'clean', got {target!r}")
    dev = resolve_device(device)
    model = StackedDenoisingAE(num_stages, device=dev,
                               generator=torch.Generator().manual_seed(seed))
    if prev_state_dict is not None:
        own = model.state_dict()
        with torch.no_grad():
            for k, v in prev_state_dict.items():
                own[k].copy_(v)
    model.train()
    prefix = model.stages[:num_stages - 1]
    prefix.eval()
    last = model.stages[-1]
    opt = torch.optim.Adam(last.parameters(), lr=lr)

    data = torch.as_tensor(np.asarray(clean) if not torch.is_tensor(clean)
                           else clean).to(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    n = len(data)
    for epoch in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            xb = data[order[i:i + batch_size]]
            with torch.no_grad():
                code = model.encode(xb, upto=num_stages - 1)
            noisy = noise_fn(code, gen)
            out = last(noisy)
            tgt = noisy if target == "noisy" else code
            loss = ((out - tgt) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if verbose:
            print(f"[denoiser s{num_stages}] epoch {epoch + 1}: "
                  f"{torch.stack(losses).mean().item():.5f}")
    model.eval()
    return {k: v.detach() for k, v in model.state_dict().items()}


def _encoder_chain(stages: Sequence[nn.Module]) -> nn.Sequential:
    """The reference's nested ``getEncoder()``: stage n's is
    ``Sequential(stage n-1's, encoder n)``, stage 1's ``Sequential(encoder
    1)``."""
    chain = nn.Sequential(stages[0])
    for enc in stages[1:]:
        chain = nn.Sequential(chain, enc)
    return chain


class DenoiserHPE(ReferenceLayout, nn.Module):
    """A pose model behind a pretrained denoising-encoder front end (ref
    HPE_{one..five}_denoiser.py::*LayerDenoiserHPE): the stacked AE's
    encoders clean the CSI ``[B, 3, 114, 10]``, then two SKUnits (M=4, G=1,
    r=4 whatever the caller passes, SKNet.py:139) and the regression MLP
    (1792 -> 34) give ``[B, 17, 2]``.  The average pools: after both SKUnits
    with 1 stage (HPE_one_denoiser.py:70,79), after the second with 2
    (HPE_two_denoiser.py:85), never with 3 or more.

    ``compute_dtype`` (bf16 by default) is the input's: the first conv runs
    in it, its fp32 bias promotes the rest to fp32, as in the JAX package.
    :func:`merge_denoiser` turns :func:`train_denoiser_stage`'s result into
    this model's ``encoder.*`` entries.  Built on ``device`` (CUDA unless
    ``"cpu"``) in eval mode, its weights from ``generator`` (seed 0 when
    None), its dropout masks from ``dropout_generator``."""

    def __init__(self, num_stages: int = 1, num_keypoints: int = 17,
                 keypoint_dims: int = 2, compute_dtype: str = "bfloat16", *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if not 1 <= num_stages <= len(STAGE_CHANNELS):
            raise ValueError(f"num_stages {num_stages}: 1-5")
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.num_stages, self.compute_dtype = num_stages, compute_dtype
        self.num_keypoints, self.keypoint_dims = num_keypoints, keypoint_dims
        self.dropout_generator = torch.Generator(device=dev)
        stages = [AEStage(cin, cout, pool, generator=gen, device=dev).encoder
                  for cin, cout, pool in STAGE_CHANNELS[:num_stages]]
        self.encoder = _encoder_chain(stages)
        code_c = STAGE_CHANNELS[num_stages - 1][1]
        self.skunit1 = SKUnitSelective(code_c, 64, 64, generator=gen,
                                       device=dev)
        self.skunit2 = SKUnitSelective(64, 128, 128, generator=gen,
                                       device=dev)
        self.regression = RegressionHead(
            128 * 14, num_keypoints * keypoint_dims, 32,
            self.dropout_generator, generator=gen, device=dev)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        y = self.skunit1(self.encoder(x.to(getattr(torch,
                                                   self.compute_dtype))))
        if self.num_stages == 1:
            y = avg_pool_nchw(y, 2, 2)
        y = self.skunit2(y)
        if self.num_stages <= 2:
            y = avg_pool_nchw(y, 2, 2)
        out = self.regression(y)
        return out.reshape(b, self.num_keypoints, self.keypoint_dims).float()

    def spec(self) -> List[Spec]:
        return denoiser_hpe_spec(self.num_stages)


def merge_denoiser(stack_state_dict: Mapping[str, torch.Tensor],
                   num_stages: int) -> Dict[str, torch.Tensor]:
    """:func:`train_denoiser_stage`'s ``state_dict`` (a
    ``StackedDenoisingAE`` of ``num_stages``) -> the ``encoder.*`` entries of
    a ``DenoiserHPE(num_stages)``: each stage's encoder conv and BN (its
    decoder has no place there).  Pass the result as ``train_pose_model``'s
    ``init_state_dict``, or load it non-strictly."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(num_stages):
        dst = _encoder_stage_prefix(num_stages, i + 1)
        for k, v in stack_state_dict.items():
            src = f"stages.{i}.encoder."
            if k.startswith(src) and k.split(".")[3] in ("0", "1"):
                out[f"{dst}.{k[len(src):]}"] = v
    return out


def frozen_denoiser_labels(model: nn.Module) -> Dict[str, str]:
    """``"freeze"`` for the ``encoder`` (the denoiser) and ``"train"`` for
    every other top-level module: the JAX package's labels of its
    ``optax.multi_transform``.  The names marked ``"freeze"`` are what
    ``train_pose_model``'s ``frozen_params`` takes."""
    return {name: ("freeze" if name == "encoder" else "train")
            for name, _ in model.named_children()}


# ---------------------------------------------------------------------------
# the specs (a copy of the JAX module's, denoiser.py:301-369)
# ---------------------------------------------------------------------------

def _encoder_stage_prefix(num_stages: int, i: int) -> str:
    """The torch key prefix of stage ``i`` (1-indexed) in the nested
    ``getEncoder()`` chain."""
    tail = ".0" if i == 1 else ".1"
    return "encoder" + ".0" * (num_stages - i) + tail


def denoiser_encoder_specs(num_stages: int, torch_root: str = "",
                           flax_root: Tuple[str, ...] = ("denoiser",)
                           ) -> List[Spec]:
    """The encoder chain's entries in a *LayerDenoiserHPE checkpoint."""
    s: List[Spec] = []
    for i in range(1, num_stages + 1):
        tp = torch_root + _encoder_stage_prefix(num_stages, i)
        fp = flax_root + (f"stage_{i - 1}",)
        s.append((f"{tp}.0.weight", "params", fp + ("enc_weight",),
                  _hwio, _hwio_inv))
        s.append((f"{tp}.0.bias", "params", fp + ("enc_bias",),
                  _ident, _ident))
        s += bn_specs(f"{tp}.1", fp + ("enc_bn",))
    return s


def ae_stage_specs(flax_prefix: Tuple[str, ...] = (),
                   torch_root: str = "") -> List[Spec]:
    """One standalone *StageAE torch module: its own encoder and decoder
    (the decoder's weights keep torch's ConvTranspose2d layout in flax)."""
    fp = flax_prefix
    s: List[Spec] = [
        (f"{torch_root}encoder.0.weight", "params", fp + ("enc_weight",),
         _hwio, _hwio_inv),
        (f"{torch_root}encoder.0.bias", "params", fp + ("enc_bias",),
         _ident, _ident),
    ]
    s += bn_specs(f"{torch_root}encoder.1", fp + ("enc_bn",))
    s.append((f"{torch_root}decoder.0.weight", "params",
              fp + ("dec1_weight",), _ident, _ident))
    s.append((f"{torch_root}decoder.0.bias", "params",
              fp + ("dec1_bias",), _ident, _ident))
    s += bn_specs(f"{torch_root}decoder.1", fp + ("dec_bn",))
    s.append((f"{torch_root}decoder.3.weight", "params",
              fp + ("dec2_weight",), _ident, _ident))
    s.append((f"{torch_root}decoder.3.bias", "params",
              fp + ("dec2_bias",), _ident, _ident))
    return s


def denoiser_hpe_spec(num_stages: int) -> List[Spec]:
    """The whole *LayerDenoiserHPE ``state_dict``."""
    return (denoiser_encoder_specs(num_stages)
            + sk_unit_selective_spec("skunit1", ("skunit1",))
            + sk_unit_selective_spec("skunit2", ("skunit2",))
            + regression_spec("regression", ("regression",)))
