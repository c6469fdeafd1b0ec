"""Port conv stack (plain version on the CPU) == JAX
``fused_conv_stack_eval`` (Pallas interpret mode), default config, fp32."""

import jax.numpy as jnp
import numpy as np
import torch

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models import fast as jax_fast
from wiflow_tpu.ops.pallas.conv_stack import (
    fused_conv_stack_eval as jax_stack, pack_conv_stack as jax_pack,
)

from tests.test_torch_harness import TOL, jax_model, port_config
from wiflow_tpu_torch.models.torch_compat import state_dict_from_jax
from wiflow_tpu_torch.ops.kernels.conv_stack import (
    conv_stack_plain, fused_conv_stack_eval, pack_conv_stack,
)


def test_conv_stack_matches_jax_kernel():
    jcfg = JaxModelConfig(compute_dtype="float32")
    _, v = jax_model(jcfg)
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((16, 240)).astype(np.float32)

    packed, widths, strides = jax_pack(v["params"], v["batch_stats"],
                                       jcfg.conv_channels, jax_fast._aff)
    ref = jax_stack(jnp.asarray(rows), packed, widths=widths,
                    strides=strides, block=16, interpret=True)

    sd = state_dict_from_jax(v, port_config(jcfg))
    blocks = pack_conv_stack(sd, 4, dtype=torch.float32,
                             device=torch.device("cpu"))
    assert [b.stride for b in blocks] == [1, 2, 2, 2, 2]
    out = fused_conv_stack_eval(torch.from_numpy(rows), blocks)
    assert out.shape == (16, 64, 15)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    # the wrapper took the plain version for a CPU tensor
    torch.testing.assert_close(out, conv_stack_plain(torch.from_numpy(rows),
                                                     blocks), rtol=0, atol=0)
