"""The HPE-Li robustness kit: noise, traditional filters, stacked
denoising autoencoders and the noise sweep (counterpart of
``wiflow_tpu/robustness``; ``add_awgn_torch`` / ``add_salt_and_pepper_torch``
are the JAX package's ``add_awgn_jax`` / ``add_salt_and_pepper_jax``)."""

from wiflow_tpu_torch.robustness.denoiser import (
    AEStage, DenoiserHPE, StackedDenoisingAE, frozen_denoiser_labels,
    merge_denoiser, train_denoiser_stage,
)
from wiflow_tpu_torch.robustness.evaluate import evaluate_robustness
from wiflow_tpu_torch.robustness.filters import gaussian_filter, mean_filter
from wiflow_tpu_torch.robustness.noise import (
    add_awgn, add_awgn_torch, add_salt_and_pepper_noise,
    add_salt_and_pepper_torch,
)
