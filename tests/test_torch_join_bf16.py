"""The bf16 ``join`` of the port against the JAX package's bf16 ``join``.

In bf16 the join's gradients move away from their fp32 values: the
forward's intermediates are rounded to bf16 (each step of the two norms,
the SiLU of h, the division by ``keep``, the sum), and the derivatives of
two SiLUs and the division by ``keep`` amplify that rounding.  At the TCN's
join of 340 channels the port's bf16 ``gh`` lies about 1.05 x 2e-2 of
max|gh| from the fp32 plain version.  Whether that is the port's own
rounding or the function's is settled here, like for like: the JAX
package's ``join`` (its Pallas kernels in interpret mode, as
``tests/test_torch_stage_fused.py`` runs them) in bf16 is the reference,
and the port's bf16 ``join_plain`` (forward, and autograd's ``gh`` and
``gres``) and ``join_backward_rounded`` (the kernels' rounding points, the
reference of the card's bf16 check) are held to it within 2e-2 of its
largest entry (``TOL_BF16`` of ``chip_smoke.py``).  Each side's distance to
its own fp32 version is printed (``pytest -s``).

Inputs as ``chip_smoke.py``'s phase 8 draws them for a join (N(0, 1) h and
res, BN vectors ``(0.3 N, U(0.5, 1.5), 0.3 N)``, an element mask kept with
probability ``keep = 1 - ModelConfig().dropout``, cotangent ``0.1 N``), with
numpy, at 4 samples of 20 steps; h, res and the cotangent are rounded to
bf16 once and given to every version, fp32 ones included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.ops.pallas.stage_fused import join as jax_join

from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.ops.kernels import stage_fused as sk

TOL_BF16 = 2e-2
KEEP = 1.0 - ModelConfig().dropout
SAMPLES, STEPS = 4, 20
# the TCN joins of the fused step: (channels, residual norm); the 340 one
# is where the bf16 gh came closest to its limit on the card
JOINS = {"c340": (340, True), "c540": (540, False), "c440": (440, True),
         "c240": (240, True)}


def draw(c, res_norm, seed):
    rng = np.random.default_rng(seed)
    shape = (SAMPLES, STEPS, c)

    def bn():
        return [(0.3 * rng.standard_normal(c)).astype(np.float32),
                rng.uniform(0.5, 1.5, c).astype(np.float32),
                (0.3 * rng.standard_normal(c)).astype(np.float32)]

    h = rng.standard_normal(shape).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    vh = bn()
    vr = bn() if res_norm else [None] * 3
    mask = rng.random(shape) < KEEP
    go = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    # h, res, go as the bf16 run holds them, for every version
    h, res, go = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                  for a in (h, res, go))
    return h, vh, mask, res, vr, go


def jax_side(h, vh, mask, res, vr, go, dtype):
    """The JAX package's join in ``dtype``: ``out``, ``gh``, ``gres`` as
    float64 numpy arrays in the port's ``[..., C]`` layout."""
    def blocks(x):        # [S, T, C] -> [S, C, T], the Pallas layout
        return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1)))

    vec = [None if v is None else jnp.asarray(v) for v in (*vh, *vr)]

    def fn(hb, rb):
        return jax_join(hb, *vec[:3], blocks(mask), rb, *vec[3:], keep=KEEP,
                        interpret=True, act_h=True)

    out, vjp = jax.vjp(fn, blocks(h).astype(dtype), blocks(res).astype(dtype))
    gh, gres = vjp(blocks(go).astype(dtype))
    return [np.asarray(x.astype(jnp.float32), np.float64).transpose(0, 2, 1)
            for x in (out, gh, gres)]


def plain_side(h, vh, mask, res, vr, go, dtype):
    """The port's ``join_plain`` in ``dtype`` and autograd's gradients."""
    hh, rr = (torch.from_numpy(x).to(dtype).requires_grad_(True)
              for x in (h, res))
    vecs = [None if v is None else torch.from_numpy(v) for v in (*vh, *vr)]
    out = sk.join_plain(hh, *vecs[:3], torch.from_numpy(mask), rr, *vecs[3:],
                        keep=KEEP, act_h=True)
    out.backward(torch.from_numpy(go).to(dtype))
    return [x.detach().double().numpy() for x in (out, hh.grad, rr.grad)]


def rounded_side(h, vh, mask, res, vr, go):
    """``join_backward_rounded`` in bf16, stored as the kernels store it."""
    bf = torch.bfloat16
    vecs = [None if v is None else torch.from_numpy(v) for v in (*vh, *vr)]
    gh, gres = sk.join_backward_rounded(
        torch.from_numpy(h).to(bf), *vecs[:3], torch.from_numpy(mask),
        torch.from_numpy(res).to(bf), *vecs[3:], torch.from_numpy(go).to(bf),
        keep=KEEP, act_h=True)
    return [x.to(bf).double().numpy() for x in (gh, gres)]


def ratio(got, ref):
    """max|got - ref| over 2e-2 x max|ref|."""
    return np.abs(got - ref).max() / (TOL_BF16 * np.abs(ref).max())


@pytest.mark.parametrize("join", JOINS)
def test_port_bf16_join_matches_the_reference_bf16_join(join):
    c, res_norm = JOINS[join]
    inputs = draw(c, res_norm, 40 + c)
    ref16 = jax_side(*inputs, jnp.bfloat16)
    ref32 = jax_side(*inputs, jnp.float32)
    plain16 = plain_side(*inputs, torch.bfloat16)
    plain32 = plain_side(*inputs, torch.float32)
    rounded16 = rounded_side(*inputs)
    names = ("out", "gh", "gres")
    print(f"\n{join}, keep {KEEP}: distance to the side's own fp32 version, "
          f"x 2e-2 of its max|.|")
    for k, name in enumerate(names):
        line = (f"  {name}: reference {ratio(ref16[k], ref32[k]):.3f}, "
                f"port join_plain {ratio(plain16[k], plain32[k]):.3f}")
        if k:
            line += (f", port join_backward_rounded "
                     f"{ratio(rounded16[k - 1], plain32[k]):.3f}")
        line += ("; to the reference, both bf16: join_plain "
                 f"{ratio(plain16[k], ref16[k]):.3f}")
        if k:
            line += (f", join_backward_rounded "
                     f"{ratio(rounded16[k - 1], ref16[k]):.3f}")
        print(line)
    # like for like: the port's bf16 against the reference's bf16
    for k, name in enumerate(names):
        assert ratio(plain16[k], ref16[k]) <= 1.0, (
            f"join_plain {name}: {ratio(plain16[k], ref16[k]):.3f} x 2e-2")
    for k, name in enumerate(names[1:]):
        assert ratio(rounded16[k], ref16[k + 1]) <= 1.0, (
            f"join_backward_rounded {name}: "
            f"{ratio(rounded16[k], ref16[k + 1]):.3f} x 2e-2")
    # the reference's fp32 and the port's fp32 agree as the fp32 tests hold
    for k, name in enumerate(names):
        assert np.abs(plain32[k] - ref32[k]).max() <= (
            2e-4 * np.abs(ref32[k]).max()), name
