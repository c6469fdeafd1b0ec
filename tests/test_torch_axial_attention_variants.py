"""The port's other two eval attention lowerings == the JAX package's, fp32
on the CPU (the Pallas kernels in interpret mode, the port's plain
versions):

* v1 (QKV projection outside the kernel) against
  ``dual_axial_attention_eval``, channels in the standard order;
* the one-launch dual kernel against ``dual_axial_attention_eval_fused``,
  whose output is unscrambled with the inverse of ``scramble_perm``;
* ``fast_forward(attention_impl=...)`` against the JAX ``fast_forward``
  with the same argument.

A bf16 case pins v1's rounding point: its qkv is rounded to bf16 before
the attention core, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models.fast import fast_forward as jax_fast_forward
from wiflow_tpu.models.wiflow import DualAxialAttention as JaxDual
from wiflow_tpu.ops.pallas.axial_attention import (
    dual_axial_attention_eval as jax_dual_v1,
    dual_axial_attention_eval_fused as jax_dual_fused, scramble_perm,
)

from tests.test_torch_axial_attention import _state_dict
from tests.test_torch_harness import (
    SMALL, TOL, jax_model, nontrivial_stats, port_config,
)
from wiflow_tpu_torch.models.fast import fast_forward, pack_fast
from wiflow_tpu_torch.ops.kernels import axial_attention as ak

C, G = 64, 8
SHAPES = [(3, 15, 20, C), (3, 17, 10, C)]     # flagship and MM-Fi geometry


def _setup(shape, dtype=torch.float32, seed=3):
    att = JaxDual(C, groups=G)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    v = att.init({"params": jax.random.key(1)}, jnp.asarray(x), train=False)
    v = nontrivial_stats(jax.tree.map(np.asarray, v))
    axes = ak.pack_axial_attention(_state_dict(v, "attention."), dtype=dtype,
                                   device=torch.device("cpu"))
    return x, v, axes


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_v1_matches_jax_v1(shape):
    x, v, axes = _setup(shape)
    ref = np.asarray(jax_dual_v1(jnp.asarray(x), v["params"],
                                 v["batch_stats"], groups=G, block=8,
                                 interpret=True))
    out = ak.dual_axial_attention_eval_v1(torch.from_numpy(x), axes).numpy()
    assert out.shape == x.shape
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dual_matches_jax_fused(shape):
    x, v, axes = _setup(shape)
    ref = np.asarray(jax_dual_fused(jnp.asarray(x), v["params"],
                                    v["batch_stats"], groups=G, block=4,
                                    interpret=True))
    # scrambled position p holds standard channel P[p]
    ref = ref[..., np.argsort(scramble_perm(C, G))]
    out = ak.dual_axial_attention_eval_fused(torch.from_numpy(x), axes)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dual_plain_is_the_v2_plain(shape):
    """One function: the one-launch kernel's plain version and the two
    launches of the v2 kernel's, and v1 beside them in fp32."""
    x, _, axes = _setup(shape)
    xt = torch.from_numpy(x)
    v2 = ak.dual_axial_attention_eval(xt, axes)
    torch.testing.assert_close(ak.dual_axial_attention_fused_plain(xt, axes),
                               v2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ak.dual_axial_attention_eval_v1(xt, axes), v2,
                               rtol=TOL, atol=TOL)


def test_v1_rounds_qkv_to_bf16_before_the_core():
    x, v, axes = _setup(SHAPES[0], dtype=torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = jax_dual_v1(jnp.asarray(x).astype(jnp.bfloat16), v["params"],
                      v["batch_stats"], groups=G, block=8, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = ak.dual_axial_attention_eval_v1(xb, axes)
    assert out.dtype == torch.bfloat16
    scale = np.abs(ref).max()
    assert np.abs(out.float().numpy() - ref).max() <= 2e-2 * scale
    # the rounding point itself: the core reads a bf16 qkv, so feeding it
    # the fp32 projection gives another result
    aw = axes[0]
    qkv = ak.project_qkv_v1(xb, aw)
    assert qkv.dtype == torch.bfloat16
    exact = xb.float() @ aw.wq.float() + aw.bq
    # one rounding of the sum, and one of the bias that enters in bf16
    torch.testing.assert_close(qkv.float(), exact, rtol=2 ** -8,
                               atol=2 ** -8 * aw.bq.abs().max().item())
    rounded = ak.axial_attention_v1_plain(qkv, aw.sim, aw.oaff)
    unrounded = ak.axial_attention_v1_plain(exact, aw.sim, aw.oaff)
    assert not torch.equal(rounded.float(), unrounded.to(torch.bfloat16).float())
    # [N, L, 3C] in, [N, L, C] out: the kernel's own signature
    n_l = qkv.reshape(-1, qkv.shape[2], 3 * C)
    torch.testing.assert_close(
        ak.axial_attention_v1(n_l, aw.sim, aw.oaff),
        rounded.reshape(-1, qkv.shape[2], C), rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["dual", "v1"])
def test_fast_forward_attention_impl_matches_jax(impl):
    jcfg = JaxModelConfig(**SMALL)
    _, v = jax_model(jcfg)
    cfg = port_config(jcfg)
    x = np.random.default_rng(5).standard_normal(
        (3, cfg.num_subcarriers, cfg.window_size)).astype(np.float32)
    ref = np.asarray(jax_fast_forward(v, jnp.asarray(x), jcfg,
                                      attention_block=4, interpret=True,
                                      attention_impl=impl))
    packed = pack_fast(v, cfg, device="cpu")
    out = fast_forward(packed, torch.from_numpy(x), attention_impl=impl)
    assert out.shape == (3, 15, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    # the three lowerings serve one function
    torch.testing.assert_close(out, fast_forward(packed, torch.from_numpy(x)),
                               rtol=TOL, atol=TOL)


def test_dual_launcher_states_its_shared_memory():
    """The one-launch kernel's block (``attention_plan``): one axis's
    packed bf16 weights, a zero row, the sample's intermediate, and fp32
    qkv of the larger tile."""
    dp = ak.attention_plan(4096, 15, 20, 64, 8, torch.float32).dual
    assert (dp.rows, dp.cols) == (3, 4)
    # fp32 stages no weights; positions C + 4 floats apart, an odd number
    # of 16-byte words, and the intermediate's rows of W positions likewise;
    # the input rows are staged into the intermediate; fp32 q, k, v rows of
    # 3C + 24 floats
    assert (dp.lda, dp.rstride) == (68, 20 * 68 + 4)
    assert dp.layout == (0, 64 * 4, 15 * 1364 * 4, 60 * (3 * 64 + 24) * 4)
    assert dp.smem == sum(dp.layout) <= 232448
    # bf16 at the flagship geometry: the packed weights, the intermediate
    # unpadded (its chunks swizzled), two blocks an SM
    dp = ak.attention_plan(4096, 15, 20, 64, 8, torch.bfloat16).dual
    assert dp.layout[:3] == (64 * 192 * 2, 128, 15 * 20 * 64 * 2)
    assert dp.smem <= 113 * 1024
    assert dp.blocks_per_sm == 2 and dp.grid == 2 * 132
    # MM-Fi geometry: 6 rows of 10, 3 columns of 17
    dp = ak.attention_plan(4096, 17, 10, 64, 8, torch.bfloat16).dual
    assert (dp.rows, dp.cols) == (6, 3)
    # a sample too large for one block is refused, whatever the device
    dp = ak.attention_plan(1, 32, 32, 128, 16, torch.float32).dual
    assert dp.smem > 232448 and dp.blocks_per_sm == 0
