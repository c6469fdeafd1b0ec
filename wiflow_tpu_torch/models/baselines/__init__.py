"""The comparison table's four baselines (ref README.md:109-120) and
HPE-Li's model zoo, ported from ``wiflow_tpu/models/baselines/``;
``convert.py`` carries the flax weights of the baselines and of
``sknet_trans.py`` across, the zoo's specs (``hpeli_zoo.py``) those of the
zoo's reference-named models."""

from wiflow_tpu_torch.models.baselines.hpeli import (
    HPELiMMFi, HPELiNet, SKConv, SKUnit,
)
from wiflow_tpu_torch.models.baselines.hpeli_zoo import (
    BasicCnnHPE, DSKNetTransMMFi, DSKNetTransWipose, HPEWiPoseModel,
    OriginalHPE, SKConvSelective, SKConvTrans, SKConvV2, SKUnitSelective,
    SKUnitTrans, SKUnitV2, state_dict_from_spec, variables_from_spec,
)
from wiflow_tpu_torch.models.baselines.performer import (
    Performer, PerformerAttention,
)
from wiflow_tpu_torch.models.baselines.perunet import PerUnet, PerUnetMMFi
from wiflow_tpu_torch.models.baselines.sknet_trans import (
    AdditiveAttention, DSKNetTrans, GlobalContextAttention,
    MultiAxisAttention, MultiHeadAttention, RegressionHead, SelfAttention,
    TransformerEncoderLayer,
)
from wiflow_tpu_torch.models.baselines.wisppn import (
    WiSPPN, convert_csi_format, extract_keypoints_from_pam,
)
from wiflow_tpu_torch.models.baselines.wpformer import (
    ChannelTransformer, WPformer, wpformer_mmfi,
)
