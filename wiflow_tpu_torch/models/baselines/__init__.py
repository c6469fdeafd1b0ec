"""The comparison table's four baselines (ref README.md:109-120), ported
from ``wiflow_tpu/models/baselines/``; ``convert.py`` carries their flax
weights across."""

from wiflow_tpu_torch.models.baselines.hpeli import (
    HPELiMMFi, HPELiNet, SKConv, SKUnit,
)
from wiflow_tpu_torch.models.baselines.performer import (
    Performer, PerformerAttention,
)
from wiflow_tpu_torch.models.baselines.perunet import PerUnet, PerUnetMMFi
from wiflow_tpu_torch.models.baselines.wisppn import (
    WiSPPN, convert_csi_format, extract_keypoints_from_pam,
)
from wiflow_tpu_torch.models.baselines.wpformer import (
    ChannelTransformer, WPformer, wpformer_mmfi,
)
