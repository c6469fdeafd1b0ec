"""WiFlow for MM-Fi in the program: ``MMFiModelConfig``,
``pack_fast_mmfi`` / ``fast_forward_mmfi`` served, ``WiFlowMMFiModel``
trained."""

from __future__ import annotations

from wiflow_tpu_torch.models.fast import fast_forward_mmfi, pack_fast_mmfi
from wiflow_tpu_torch.models.wiflow_mmfi import (
    MMFiModelConfig, WiFlowMMFiModel,
)

from benchmark.program import dataclass_from


def model_config(cfg, **switches) -> MMFiModelConfig:
    return dataclass_from(MMFiModelConfig, cfg, **switches)


def serve_forward(sd, cfg, device):
    packed = pack_fast_mmfi(sd, model_config(cfg), device=device)
    return lambda x: fast_forward_mmfi(packed, x)


def train_model(cfg, device, **switches) -> WiFlowMMFiModel:
    return WiFlowMMFiModel(model_config(cfg, **switches), device=device)
