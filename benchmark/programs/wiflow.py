"""WiFlow in the program: ``ModelConfig``, ``pack_fast`` /
``fast_forward`` served, ``WiFlowPoseModel`` trained."""

from __future__ import annotations

from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.models.fast import fast_forward, pack_fast
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel

from benchmark.program import dataclass_from


def model_config(cfg, **switches) -> ModelConfig:
    return dataclass_from(ModelConfig, cfg, **switches)


def serve_forward(sd, cfg, device, attention_impl: str = "v2"):
    packed = pack_fast(sd, model_config(cfg), device=device)
    return lambda x: fast_forward(packed, x, attention_impl=attention_impl)


def train_model(cfg, device, **switches) -> WiFlowPoseModel:
    return WiFlowPoseModel(model_config(cfg, **switches), device=device)
