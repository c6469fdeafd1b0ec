"""``fast_forward``'s stock-op lowerings == the JAX package's, fp32 on the
CPU.

Every ``(fuse_tcn, fuse_conv_stack)`` pair under each ``attention_impl``
is held to the JAX ``fast_forward`` with the same flags (its Pallas
kernels in interpret mode) from the same weights, at 2e-4.  The JAX
function runs unjitted (its jit leaves ``fuse_tcn`` out of its static
arguments); each Pallas kernel is then compiled once, on its first call,
and serves every combination after it.

The seeded model's output hardly depends on its input (its spread over
windows is 1e-5 of its size), so the BN scales and shifts are spread
first (:func:`_lively`): then a lowering that computed another function
would miss the tolerance by far.  The stock lowerings fold their weights
from the ``state_dict`` alone, not from the kernels' packs: a pack folded
wrong shows as a difference between the lowerings, which the
mis-folding tests check.

In bf16 the stock lowerings round where the JAX package's stock ops
round: each stock TCN level and conv block, fed the JAX layer's bf16
input, gives the JAX ``_tcn_level`` / ``_conv_block``'s bits but for
accumulation order (measured on a CPU: at most 1.6% of the values differ,
by at most 2.3e-3 of the largest; ``F.silu``, which rounds once where
``jax.nn.silu`` rounds four times, moved 48-63% of them).  End to end,
bf16 rounding noise grows through the spread BatchNorms until it says
nothing of where a lowering rounds, so the check is a layer's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.core.config import ModelConfig as JaxModelConfig
from wiflow_tpu.models.fast import fast_forward as jax_fast_forward

from tests.test_torch_harness import (
    SMALL, TOL, jax_model, port_config,
)
from wiflow_tpu_torch.models import fast
from wiflow_tpu_torch.models.fast import fast_forward, pack_fast

FLAGS = [(True, True), (False, True), (True, False), (False, False)]
IMPLS = ["v2", "dual", "v1"]

def _lively(tree):
    """Every BN's scale times 1.7 (1 + sin / 2), its shift plus cos / 10:
    an output that spreads by a fifth of its size over the windows."""
    out = {}
    for k, a in tree.items():
        if isinstance(a, dict):
            out[k] = _lively(a)
        elif a.ndim == 1 and k == "weight":
            out[k] = a * 1.7 * (1 + 0.5 * np.sin(np.arange(a.size)))
        elif a.ndim == 1 and k == "bias":
            out[k] = a + 0.1 * np.cos(np.arange(a.size))
        else:
            out[k] = a
    return out


@pytest.fixture(scope="module")
def setup():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = JaxModelConfig(**SMALL)
    _, v = jax_model(jcfg, seed=2)
    v = {"params": _lively(v["params"]), "batch_stats": v["batch_stats"]}
    cfg = port_config(jcfg)
    x = np.random.default_rng(11).standard_normal(
        (3, cfg.num_subcarriers, cfg.window_size)).astype(np.float32)
    refs = {}

    def ref(impl="v2", fuse_tcn=True, fuse_conv_stack=True):
        key = (impl, fuse_tcn, fuse_conv_stack)
        if key not in refs:
            refs[key] = np.asarray(jax_fast_forward.__wrapped__(
                v, jnp.asarray(x), jcfg, attention_block=4, interpret=True,
                attention_impl=impl, fuse_tcn=fuse_tcn,
                fuse_conv_stack=fuse_conv_stack))
        return refs[key]

    yield ref, pack_fast(v, cfg, device="cpu"), x
    torch.set_num_threads(threads)


def test_output_depends_on_the_input(setup):
    ref, _, _ = setup
    out = ref()
    assert out.std(axis=0).max() > 0.1 * np.abs(out).max()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fuse_tcn,fuse_conv_stack", FLAGS,
                         ids=["fused", "stock_tcn", "stock_conv", "stock"])
def test_lowering_matches_jax(setup, impl, fuse_tcn, fuse_conv_stack):
    ref, packed, x = setup
    out = fast_forward(packed, torch.from_numpy(x), attention_impl=impl,
                       fuse_tcn=fuse_tcn, fuse_conv_stack=fuse_conv_stack)
    assert out.shape == (3, 15, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref(impl, fuse_tcn,
                                                fuse_conv_stack),
                               rtol=TOL, atol=TOL)


def test_stock_weights_are_folded_apart_from_the_packs(setup):
    """The stock layouts are tensors of their own, not views of the
    kernels' packs."""
    _, packed, _ = setup
    kernel = {t.data_ptr() for lv in packed.tcn for t in lv[:10]
              if t is not None}
    kernel |= {t.data_ptr() for blk in packed.conv for t in blk[:8]}
    stock = {t.data_ptr() for lv in packed.stock_tcn
             for wb in (lv.g1, lv.p1, lv.g2, lv.p2, lv.down) if wb
             for t in wb}
    stock |= {t.data_ptr() for blk in packed.stock_conv
              for wb in (*blk.convs, blk.down) for t in wb}
    assert stock and not stock & kernel


def _misfolded(packed, part):
    """``packed`` with one kernel pack folded wrong: the TCN's first
    grouped conv, or the conv stack's first shortcut, scaled by 1.25."""
    if part == "tcn":
        lv = packed.tcn[0]
        tcn = [lv._replace(g1w=lv.g1w * 1.25)] + list(packed.tcn[1:])
        return dataclasses.replace(packed, tcn=tcn)
    blocks = list(packed.conv.blocks)
    blocks[1] = blocks[1]._replace(wd=blocks[1].wd * 1.25)
    return dataclasses.replace(
        packed, conv=dataclasses.replace(packed.conv, blocks=tuple(blocks)))


@pytest.mark.parametrize("part", ["tcn", "conv"])
def test_misfolded_pack_is_told_apart(setup, part):
    """A mis-folded kernel pack moves the fused lowering off the JAX
    reference; the stock lowering of that part stays on it."""
    ref, packed, x = setup
    ref = ref()
    bad = _misfolded(packed, part)
    xt = torch.from_numpy(x)
    fused = fast_forward(bad, xt).numpy()
    flags = ({"fuse_tcn": False} if part == "tcn"
             else {"fuse_conv_stack": False})
    stock = fast_forward(bad, xt, **flags).numpy()
    assert np.abs(fused - ref).max() > 100 * TOL * np.abs(ref).max()
    np.testing.assert_allclose(stock, ref, rtol=TOL, atol=TOL)


# a stock layer in bf16 against the JAX one: at most this share of the
# values may differ, by at most this much of the largest (sound: 1.6%,
# 2.3e-3; a once-rounded silu: 48-63%)
BF16_DIFFERING, BF16_MAX = 0.05, 2.0 ** -7
LAYERS = ["tcn0", "tcn1", "up", "res0", "res1", "res2", "res3"]


@pytest.fixture(scope="module")
def bf16_layers():
    """Each stock layer's bf16 input and the JAX layer's bf16 output, the
    layers chained on the JAX outputs, and the port's bf16 pack."""
    import jax
    from wiflow_tpu.models import fast as jax_fast
    jcfg = JaxModelConfig(**{**SMALL, "compute_dtype": "bfloat16"})
    _, v = jax_model(JaxModelConfig(**SMALL), seed=2)
    p, st = _lively(v["params"]), v["batch_stats"]
    packed = pack_fast({"params": p, "batch_stats": st}, port_config(jcfg),
                       device="cpu")
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (8, jcfg.window_size, jcfg.num_subcarriers)), jnp.bfloat16)
    io = {}
    for i in range(len(jcfg.tcn_channels)):
        y = jax_fast._tcn_level(p["tcn"][f"network_{i}"],
                                st["tcn"][f"network_{i}"], x, dilation=2 ** i,
                                groups=jcfg.tcn_groups, dtype=jnp.bfloat16)
        io[f"tcn{i}"], x = (x, y), y
    x = x[..., None]
    names = ["up"] + [f"residual_blocks_{j}"
                      for j in range(len(jcfg.conv_channels))]
    for k, name in enumerate(names):
        y = jax_fast._conv_block(p[name], st[name], x,
                                 stride_w=1 if k == 0 else 2,
                                 dtype=jnp.bfloat16)
        io[LAYERS[2 + k]], x = (x, y), y
    f32 = {k: tuple(np.asarray(a.astype(jnp.float32)) for a in pair)
           for k, pair in jax.device_get(io).items()}
    return f32, packed


def _stock_layer(packed, name, x):
    xt = torch.from_numpy(x).to(torch.bfloat16)
    if name.startswith("tcn"):
        return fast._stock_tcn_level(packed.stock_tcn[int(name[3:])], xt)
    return fast._stock_conv_block(packed.stock_conv[LAYERS.index(name) - 2],
                                  xt)


def _bf16_distance(got, ref):
    """(share of the values that differ, max |diff| / max |ref|)."""
    got = got.float().numpy()
    return ((got != ref).mean(),
            np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", LAYERS)
def test_stock_layer_rounds_as_jax_in_bf16(bf16_layers, name):
    io, packed = bf16_layers
    x, ref = io[name]
    got = _stock_layer(packed, name, x)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    differing, worst = _bf16_distance(got, ref)
    assert differing <= BF16_DIFFERING and worst <= BF16_MAX, (
        name, differing, worst)


def test_once_rounded_silu_is_told_apart(bf16_layers, monkeypatch):
    """The control: with ``F.silu`` in place of the JAX formula, the
    first TCN level misses the bound by far."""
    io, packed = bf16_layers
    monkeypatch.setattr(fast, "_silu", torch.nn.functional.silu)
    x, ref = io["tcn0"]
    differing, _ = _bf16_distance(_stock_layer(packed, "tcn0", x), ref)
    assert differing > 4 * BF16_DIFFERING, differing
