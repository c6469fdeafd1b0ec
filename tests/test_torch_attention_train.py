"""Port train-mode attention functions == the Pallas kernels, CPU, fp32.

``axial_core`` and ``logits_sums`` (the port's plain versions, which its
wrappers run on CPU tensors) against the Pallas kernels in interpret mode,
values and VJPs, at both axes' lengths (20 and 15) and a sequence count
that leaves the last block (``block=8``) part-filled; ``logits_moments``
against brute-force logits.  The modules are held against flax in
``tests/test_torch_attention_train_modules.py``.

Channels per group are 2 here (8 on the card; the plain versions take
any): the interpreted kernels unroll their loops over L x L x channels,
and their compile time grows with it.

Tolerances, relative to the largest entry of the reference: values 2e-4
as the serving tests (``TOL``); gradients 1e-3 (the backward sums many
more terms than the forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.ops.pallas import axial_attention_train as jax_train
from wiflow_tpu.ops.pallas.axial_attention import scramble_perm

from tests.test_torch_harness import TOL
from wiflow_tpu_torch.ops.kernels.axial_attention_train import (
    axial_core, logits_moments, logits_moments_fused, logits_sums,
)

GRAD_TOL = 1e-3
C, G = 8, 4
AXES = [pytest.param(20, 11, id="width-L20"),
        pytest.param(15, 11, id="height-L15")]


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _to_kernel_layout(t):
    """``[N, L, C]`` standard -> the Pallas kernels' scrambled ``[L, C, N]``
    (scrambled position p holds standard channel perm[p])."""
    perm = scramble_perm(C, G)
    return jnp.asarray(np.ascontiguousarray(t[:, :, perm].transpose(1, 2, 0)))


def _from_kernel_layout(t):
    inv = np.argsort(scramble_perm(C, G))
    return np.asarray(t).transpose(2, 0, 1)[:, :, inv]


def _qkv(rng, n, length, count=3):
    return [rng.standard_normal((n, length, C)).astype(np.float32)
            for _ in range(count)]


def _leaves(ts):
    return [torch.from_numpy(t).requires_grad_(True) for t in ts]


@pytest.mark.parametrize("length,n", AXES)
def test_axial_core_and_vjp_match_pallas(length, n):
    rng = np.random.default_rng(length)
    q, k, v = _qkv(rng, n, length)
    scale = rng.uniform(0.3, 1.5, G).astype(np.float32)
    dout = rng.standard_normal((n, length, C)).astype(np.float32)

    def core(qt, kt, vt, s):
        return jax_train.axial_core(qt, kt, vt, s, G, 8, True)

    ref, vjp = jax.vjp(core, *map(_to_kernel_layout, (q, k, v)),
                       jnp.asarray(scale))
    rdq, rdk, rdv, rds = vjp(_to_kernel_layout(dout))

    tq, tk, tv, ts = _leaves((q, k, v, scale))
    out = axial_core(tq, tk, tv, ts)
    out.backward(torch.from_numpy(dout))
    _close(out.detach(), _from_kernel_layout(ref), TOL, "out")
    for name, got, want in (("dq", tq.grad, _from_kernel_layout(rdq)),
                            ("dk", tk.grad, _from_kernel_layout(rdk)),
                            ("dv", tv.grad, _from_kernel_layout(rdv)),
                            ("dscale", ts.grad, rds)):
        _close(got, want, GRAD_TOL, name)


@pytest.mark.parametrize("length,n", AXES)
def test_logits_sums_and_vjp_match_pallas(length, n):
    rng = np.random.default_rng(100 + length)
    q, k = _qkv(rng, n, length, 2)
    dsums = rng.standard_normal((2, G)).astype(np.float32)

    ref, vjp = jax.vjp(lambda a, b: jax_train.logits_sums(a, b, G, 8, True),
                       _to_kernel_layout(q), _to_kernel_layout(k))
    rdq, rdk = vjp(jnp.asarray(dsums))

    tq, tk = _leaves((q, k))
    sums = logits_sums(tq, tk, G)
    sums.backward(torch.from_numpy(dsums))
    _close(sums.detach(), ref, TOL, "sums")
    _close(tq.grad, _from_kernel_layout(rdq), GRAD_TOL, "dq")
    _close(tk.grad, _from_kernel_layout(rdk), GRAD_TOL, "dk")

    count = n * length * length
    mean, var = logits_moments_fused(tq, tk, G, count)
    jmean, jvar = jax_train.logits_moments_fused(
        _to_kernel_layout(q), _to_kernel_layout(k), G, count, 8, True)
    _close(mean.detach(), jmean, TOL, "mean")
    _close(var.detach(), jvar, TOL, "var")


def test_logits_moments_match_brute_force():
    rng = np.random.default_rng(3)
    n, length, c, g = 7, 5, 12, 4
    q = rng.standard_normal((n, length, c)).astype(np.float32)
    k = rng.standard_normal((n, length, c)).astype(np.float32)
    mean, var = logits_moments(torch.from_numpy(q), torch.from_numpy(k), g)
    lg = np.einsum("bigc,bjgc->gijb", q.reshape(n, length, g, c // g),
                   k.reshape(n, length, g, c // g)).astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), lg.mean(axis=(1, 2, 3)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), lg.var(axis=(1, 2, 3)),
                               rtol=1e-4, atol=1e-5)
