"""Port dual axial attention == JAX, at ``[2, 15, 20, 32]`` with G=4, fp32.

The port's plain kernel version is held against the JAX v2 kernel
(Pallas interpret mode, output unscrambled with the inverse of
``scramble_perm``) and
against the flax module; the port's ``nn.Module`` against the flax module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wiflow_tpu.models.wiflow import DualAxialAttention as JaxDual
from wiflow_tpu.ops.pallas.axial_attention import (
    dual_axial_attention_eval_v2, scramble_perm,
)

from tests.test_torch_harness import TOL, nontrivial_stats
from wiflow_tpu_torch.models.torch_compat import load_state_dict
from wiflow_tpu_torch.models.wiflow import DualAxialAttention
from wiflow_tpu_torch.ops.kernels.axial_attention import (
    dual_axial_attention_eval, pack_axial_attention,
)

C, G = 32, 4


def _state_dict(v, prefix):
    """The flax DualAxialAttention tree under the reference torch names."""
    sd = {}
    for axis in ("width_axis", "height_axis"):
        p, s = v["params"][axis], v["batch_stats"][axis]
        sd[f"{prefix}{axis}.qkv_transform.weight"] = torch.from_numpy(
            np.ascontiguousarray(p["qkv_weight"].T[:, :, None]))
        for bn in ("bn_qkv", "bn_similarity", "bn_output"):
            for k, tree, name in (("weight", p, "weight"), ("bias", p, "bias"),
                                  ("running_mean", s, "running_mean"),
                                  ("running_var", s, "running_var")):
                sd[f"{prefix}{axis}.{bn}.{k}"] = torch.from_numpy(
                    np.array(tree[bn][name]))
    return sd


def test_dual_attention_matches_jax():
    att = JaxDual(C, groups=G)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 15, 20, C)).astype(np.float32)
    v = att.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)
    v = nontrivial_stats(jax.tree.map(np.asarray, v))
    ref_module = np.asarray(att.apply(v, jnp.asarray(x), train=False))
    ref_kernel = dual_axial_attention_eval_v2(
        jnp.asarray(x), v["params"], v["batch_stats"], groups=G, block=8,
        interpret=True)
    # scrambled position p holds standard channel P[p]
    ref_kernel = np.asarray(ref_kernel)[..., np.argsort(scramble_perm(C, G))]

    axes = pack_axial_attention(_state_dict(v, "attention."),
                                dtype=torch.float32,
                                device=torch.device("cpu"))
    out = dual_axial_attention_eval(torch.from_numpy(x), axes).numpy()
    assert out.shape == x.shape
    np.testing.assert_allclose(out, ref_kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, ref_module, rtol=TOL, atol=TOL)

    module = load_state_dict(DualAxialAttention(C, G, device="cpu"),
                             _state_dict(v, "")).eval()
    with torch.no_grad():
        out_module = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_module, ref_module, rtol=TOL, atol=TOL)
