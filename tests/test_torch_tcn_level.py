"""Port TCN level (plain version on the CPU) == JAX ``fused_tcn_eval``.

The JAX kernel runs in Pallas interpret mode.  fp32 throughout, at the
tolerance ``tests/test_fast_path.py`` uses for the same kernel.
"""

import jax.numpy as jnp
import numpy as np
import torch

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models import fast as jax_fast
from wiflow_tpu.ops.pallas.tcn_level import fused_tcn_eval as jax_tcn
from wiflow_tpu.ops.pallas.tcn_level import pack_tcn_levels as jax_pack

from tests.test_torch_harness import SMALL, TOL, jax_model, port_config
from wiflow_tpu_torch.models.torch_compat import state_dict_from_jax
from wiflow_tpu_torch.ops.kernels.tcn_level import (
    fused_tcn_eval, pack_tcn_levels, tcn_level,
)


def test_tcn_stack_matches_jax_kernel_small_config():
    jcfg = JaxModelConfig(**SMALL)
    _, v = jax_model(jcfg)
    n = len(jcfg.tcn_channels)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 20, jcfg.num_subcarriers)).astype(np.float32)

    packed = jax_pack(v["params"]["tcn"], v["batch_stats"]["tcn"], n,
                      jax_fast._aff)
    ref = jax_tcn(jnp.asarray(x), packed,
                  dilations=tuple(2 ** i for i in range(n)), block=8,
                  interpret=True)

    sd = state_dict_from_jax(v, port_config(jcfg))
    levels = pack_tcn_levels(sd, n, jcfg.tcn_groups, dtype=torch.float32,
                             device=torch.device("cpu"))
    out = fused_tcn_eval(torch.from_numpy(x), levels)
    assert out.shape == (5, 20, 240)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_full_width_level_matches_jax_kernel():
    """Level 1 of the default config: 540 -> 440, dilation 2, with the
    1x1 residual, batch 2."""
    jcfg = JaxModelConfig(compute_dtype="float32")
    _, v = jax_model(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 540)).astype(np.float32)

    packed = jax_pack(v["params"]["tcn"], v["batch_stats"]["tcn"], 4,
                      jax_fast._aff)
    ref = jax_tcn(jnp.asarray(x), [packed[1]], dilations=(2,), block=8,
                  interpret=True)

    sd = state_dict_from_jax(v, port_config(jcfg))
    lv = pack_tcn_levels(sd, 4, 20, dtype=torch.float32,
                         device=torch.device("cpu"))[1]
    assert lv.dilation == 2 and lv.dw is not None
    out = tcn_level(torch.from_numpy(x), lv)
    assert out.shape == (2, 20, 440)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
