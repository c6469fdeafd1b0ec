"""The port's ``stage`` and ``join`` == the JAX package's, on the CPU.

The same numpy inputs go through ``wiflow_tpu/ops/pallas/stage_fused.py``
(its Pallas kernels in interpret mode, as ``tests/test_stage_fused.py``
runs them) and through the plain versions of
``wiflow_tpu_torch/ops/kernels/stage_fused.py``, which a CPU tensor takes:
outputs, the per-channel sums, and every gradient (x, m, a, b, weight,
bias) with cotangents on the output and on both sums.

Only layouts differ.  The JAX side works on ``[ng, C, t*nb]`` blocks with
lanes ordered (time or chunk, batch), the port on ``[B, W, C]`` rows with
``B = ng * nb``; at chunk size 1 the JAX conv kinds are plain convs over
the chunk axis.  The JAX weight is a packed ``[taps * Ci, Co]`` matrix (a
grouped conv as its block-diagonal expansion), the port's is torch's
``[Co, Ci / G, K]``.  The JAX ``chunk1:2`` takes both chunks of a pair,
each with its own weight block; a 1x1 conv of stride 2 is that with the
second block zero.

Tolerances are those of ``tests/test_stage_fused.py``: outputs 2e-5, sums
1e-4, gradients 3e-4 (``rtol`` and ``atol``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.ops.pallas.stage_fused import join as jax_join
from wiflow_tpu.ops.pallas.stage_fused import stage as jax_stage

from wiflow_tpu_torch.ops.kernels import stage_fused as sk

KEEP = 0.7
NG, CI, CO, T, NB = 2, 24, 16, 20, 8
GROUPS = 2


def blocks_to_rows(xb):
    """``[ng, C, w*nb]`` lane blocks -> ``[ng*nb, w, C]`` rows."""
    ng, c, l = xb.shape
    return np.ascontiguousarray(
        np.asarray(xb).reshape(ng, c, l // NB, NB).transpose(0, 3, 2, 1)
    ).reshape(ng * NB, l // NB, c)


def rows_to_blocks(x):
    """Inverse of :func:`blocks_to_rows`."""
    b, w, c = x.shape
    return np.ascontiguousarray(
        np.asarray(x).reshape(b // NB, NB, w, c).transpose(0, 3, 2, 1)
    ).reshape(b // NB, c, w * NB)


def bd_pack(wg):
    """``[K, G, ci, co]`` grouped taps -> block-diagonal ``[K*G*ci, G*co]``
    (``wiflow_tpu/models/wiflow.py::TCNLevel._fused_blocks``)."""
    kk, g, ci, co = wg.shape
    eye = jnp.eye(g, dtype=wg.dtype)
    return (wg[:, :, :, None, :] * eye[None, :, None, :, None]).reshape(
        kk * g * ci, g * co)


# kind -> (JAX segment, taps of the port's conv, groups, dilation)
KINDS = {"identity": ("identity", 1, 1, 1), "causal3": ("causal3", 3, GROUPS, 2),
         "sym3": ("sym3", 3, 1, 1), "chunk3": ("chunk3:2", 3, 1, 1),
         "chunk1": ("chunk1:2", 1, 1, 1)}


def jax_weight(kind, wg):
    """The packed JAX weight of the port-layout taps ``wg [K, G, ci, co]``."""
    w = bd_pack(wg)
    if kind == "chunk1":
        w = jnp.concatenate([w, jnp.zeros_like(w)], axis=0)
    return w


def torch_weight(wg):
    """``[K, G, ci, co]`` -> torch's ``[G*co, ci, K]``."""
    k, g, ci, co = wg.shape
    return np.ascontiguousarray(
        np.asarray(wg).transpose(1, 3, 2, 0)).reshape(g * co, ci, k)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("has_pro,has_mask,has_bias,emit", [
    (True, True, True, True),
    (False, False, False, True),
    (True, False, True, False),
])
def test_stage_plain_matches_jax_stage(kind, has_pro, has_mask, has_bias,
                                       emit):
    seg, taps, groups, dil = KINDS[kind]
    rng = np.random.default_rng(0)
    l = T * NB
    xb = rng.standard_normal((NG, CI, l)).astype(np.float32)
    vecs = [rng.standard_normal(CI).astype(np.float32) if has_pro else None
            for _ in range(3)]
    mask = (rng.random((NG, CI, l)) < KEEP) if has_mask else None
    wg = (rng.standard_normal((taps, groups, CI // groups, CO // groups))
          * 0.1).astype(np.float32)
    bias = rng.standard_normal(CO).astype(np.float32) if has_bias else None
    l_out = l // 2 if kind.startswith("chunk") else l
    gvec = (rng.standard_normal((NG, CO, l_out)) * .1).astype(np.float32)
    pv = rng.standard_normal(CO).astype(np.float32)
    qv = (rng.standard_normal(CO) * .01).astype(np.float32)

    # -- the JAX package: the Pallas kernels, interpreted
    kw = dict(seg=seg, dil=dil, t=T, nb=NB, keep=KEEP, emit_stats=emit,
              interpret=True)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(xb, m, a, b, wg, bias):
        o, p, q = jax_stage(xb, m, a, b, jmask, jax_weight(kind, wg), bias,
                            **kw)
        r = jnp.sum(o * gvec)
        if emit:
            r = r + jnp.sum(p * pv) + jnp.sum(q * qv)
        return r, (o, p, q)

    jargs = [None if a is None else jnp.asarray(a)
             for a in (xb, *vecs, wg, bias)]
    argn = tuple(i for i, a in enumerate(jargs) if a is not None)
    jgrads, (jo, jp, jq) = jax.grad(jloss, argn, has_aux=True)(*jargs)
    jgrads = dict(zip(argn, jgrads))

    # -- the port: the plain version, which a CPU tensor takes
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True)
              for a in (blocks_to_rows(xb), *vecs, torch_weight(wg), bias)]
    tmask = None if mask is None else torch.from_numpy(blocks_to_rows(mask))
    out, sums = sk.stage(leaves[0], leaves[1], leaves[2], leaves[3], tmask,
                         leaves[4], leaves[5], kind=kind, dil=dil, keep=KEEP,
                         stats=emit)
    np.testing.assert_allclose(rows_to_blocks(out.detach().numpy()), jo,
                               rtol=2e-5, atol=2e-5)
    loss = (out * torch.from_numpy(blocks_to_rows(gvec))).sum()
    if emit:
        np.testing.assert_allclose(sums[0].detach(), jp, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(sums[1].detach(), jq, rtol=1e-4, atol=1e-4)
        loss = loss + (sums[0] * torch.from_numpy(pv)).sum() \
            + (sums[1] * torch.from_numpy(qv)).sum()
    else:
        assert sums is None
    loss.backward()
    for i, name in enumerate(("x", "m", "a", "b", "weight", "bias")):
        if leaves[i] is None:
            continue
        got, ref = leaves[i].grad.numpy(), np.asarray(jgrads[i])
        if name == "x":
            got = rows_to_blocks(got)
        elif name == "weight":
            ref = torch_weight(ref)
        np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4,
                                   err_msg=name)


@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("has_rn", [True, False])
@pytest.mark.parametrize("act_h", [True, False])
def test_join_plain_matches_jax_join(has_mask, has_rn, act_h):
    rng = np.random.default_rng(1)
    c, l = CI, T * NB
    hb, rb, gvec = (rng.standard_normal((NG, c, l)).astype(np.float32)
                    for _ in range(3))
    gvec *= .1
    vh = [rng.standard_normal(c).astype(np.float32) for _ in range(3)]
    vr = [rng.standard_normal(c).astype(np.float32) if has_rn else None
          for _ in range(3)]
    mask = (rng.random((NG, c, l)) < KEEP) if has_mask else None
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(hb, mh, ah, bh, rb, mr, ar, br):
        return jnp.sum(jax_join(hb, mh, ah, bh, jmask, rb, mr, ar, br,
                                keep=KEEP, interpret=True, act_h=act_h)
                       * gvec)

    jargs = [None if a is None else jnp.asarray(a)
             for a in (hb, *vh, rb, *vr)]
    argn = tuple(i for i, a in enumerate(jargs) if a is not None)
    jgrads = dict(zip(argn, jax.grad(jloss, argn)(*jargs)))
    jout = jax_join(*jargs[:4], jmask, *jargs[4:], keep=KEEP, interpret=True,
                    act_h=act_h)

    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True)
              for a in (blocks_to_rows(hb), *vh, blocks_to_rows(rb), *vr)]
    tmask = None if mask is None else torch.from_numpy(blocks_to_rows(mask))
    out = sk.join(*leaves[:4], tmask, *leaves[4:], keep=KEEP, act_h=act_h)
    np.testing.assert_allclose(rows_to_blocks(out.detach().numpy()), jout,
                               rtol=2e-5, atol=2e-5)
    (out * torch.from_numpy(blocks_to_rows(gvec))).sum().backward()
    for i, leaf in enumerate(leaves):
        if leaf is None:
            continue
        got = leaf.grad.numpy()
        if i in (0, 4):
            got = rows_to_blocks(got)
        np.testing.assert_allclose(got, np.asarray(jgrads[i]), rtol=3e-4,
                                   atol=3e-4, err_msg=str(i))


def test_per_sample_mask_equals_its_expansion():
    """One keep bit per (sample, channel), as the conv stack's Dropout2d
    draws it, gives what the same bits expanded over (H, W) give."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 4, 10, 8)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((3, 4, 10, 8)).astype(
        np.float32))
    m, a, b = (torch.from_numpy(rng.standard_normal(8).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rng.standard_normal((8, 8, 1, 3)).astype(np.float32))
    bits = torch.from_numpy(rng.random((3, 1, 1, 8)) < KEEP)
    full = bits.expand(3, 4, 10, 8).contiguous()
    for mask in (bits, bits.reshape(3, 8)):
        o1, s1 = sk.stage(x, m, a, b, mask, w, None, kind="sym3", keep=KEEP)
        o2, s2 = sk.stage(x, m, a, b, full, w, None, kind="sym3", keep=KEEP)
        torch.testing.assert_close(o1, o2, rtol=0, atol=0)
        torch.testing.assert_close(s1, s2, rtol=0, atol=0)
        j1 = sk.join(x, m, a, b, mask, res, keep=KEEP)
        j2 = sk.join(x, m, a, b, full, res, keep=KEEP)
        torch.testing.assert_close(j1, j2, rtol=0, atol=0)


def test_stage_rejects_what_it_cannot_take():
    x = torch.zeros(2, 5, 6)
    w = torch.zeros(4, 6, 1)
    with pytest.raises(ValueError, match="kind"):
        sk.stage(x, None, None, None, None, w, None, kind="sym5")
    with pytest.raises(ValueError, match="does not fit"):
        sk.stage(x, None, None, None, None, w, None, kind="sym3")
    with pytest.raises(ValueError, match="mask"):
        sk.stage(x, None, None, None, torch.ones(5, 6, dtype=torch.bool), w,
                 None, kind="identity")
    with pytest.raises(TypeError, match="bool"):
        sk.stage(x, None, None, None, torch.ones(2, 5, 6), w, None,
                 kind="identity")
