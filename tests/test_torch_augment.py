"""The port's augmentation against the JAX package's, on the CPU.

``apply_mask_spans``, the deterministic core, gets the same spans on both
sides: on rows whose every partial sum is exact in fp32 (multiples of 1/8
that sum to 0 over the row) the outputs are equal bit for bit; on N(0, 1)
rows within 1e-6 of the largest value (the fill means summed in another
order).  The random parts are held to the JAX package's own tests
(``tests/test_augment.py:151-182``): 1-2 spans of 5-9 subcarriers along
the subcarrier axis only, the noise's scale within 20%, the scaling
within [0.9, 1.1] and sometimes the identity; over many draws
``augment_batch`` masks only whole subcarrier rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.data import augment as jax_aug

from wiflow_tpu_torch.data import augment

FLOAT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pool in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(rng, b, t):
    apply = rng.random(b) < 0.7
    num = rng.integers(1, 3, b)
    lens = rng.integers(5, 10, (b, 2))
    starts = np.floor(rng.random((b, 2)) * (t - lens)).astype(np.int64)
    return apply, num, lens, starts


def _both(x, spans):
    ref = np.asarray(jax_aug.apply_mask_spans(jnp.asarray(x),
                                              *map(jnp.asarray, spans)))
    got = augment.apply_mask_spans(torch.from_numpy(x),
                                   *map(torch.from_numpy, spans)).numpy()
    return got, ref


@pytest.mark.parametrize("seed", range(6))
def test_apply_mask_spans_equals_jax(seed):
    rng = np.random.default_rng(seed)
    b, c, t = 16, 20, 540
    half = (rng.integers(-64, 64, (b, c, t // 2)) / 8).astype(np.float32)
    x = np.concatenate([half, -half], axis=2)
    x = np.take_along_axis(x, np.argsort(rng.random(x.shape), axis=2), 2)
    spans = _spans(rng, b, t)
    got, ref = _both(x, spans)
    np.testing.assert_array_equal(got, ref)
    assert (got != x).any()

    x = rng.standard_normal((b, c, t)).astype(np.float32)
    got, ref = _both(x, spans)
    assert np.abs(got - ref).max() <= FLOAT_TOL * np.abs(ref).max()


def _masked_subcarriers(x, out):
    """Per sample, the subcarriers whose whole row changed; asserts that no
    other entry changed."""
    changed = out != x                                   # [B, S, T]
    rows = changed.any(axis=2)
    assert (changed == (rows[:, :, None] & np.ones_like(changed))).all(), \
        "a change that is not a whole subcarrier row"
    return rows


def test_subcarrier_masking_masks_spans_of_the_subcarrier_axis():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 540, 20)).astype(np.float32)
    counts, jax_counts = [], []
    gen = torch.Generator().manual_seed(0)
    for i in range(64):
        out = augment.subcarrier_masking(torch.from_numpy(x), gen,
                                         mask_ratio=1.0).numpy()
        rows = _masked_subcarriers(x, out)
        for r in rows:
            idx = np.flatnonzero(r)
            runs = np.split(idx, np.flatnonzero(np.diff(idx) > 1) + 1)
            # two spans may overlap or touch and read as one run
            assert len(runs) in (1, 2), runs
            lo, hi = (5, 9) if len(runs) == 2 else (5, 18)
            assert all(lo <= len(u) <= hi for u in runs), runs
        counts.append(rows.sum(axis=1))
        jout = np.asarray(jax_aug.subcarrier_masking(
            jnp.asarray(x), jax.random.key(i), mask_ratio=1.0))
        jax_counts.append(_masked_subcarriers(x, jout).sum(axis=1))
    counts, jax_counts = np.concatenate(counts), np.concatenate(jax_counts)
    assert 5 <= counts.min() and counts.max() <= 18
    # E[masked] ~ 10.5 of 540 on both sides (the JAX test's bound)
    assert abs(counts.mean() - jax_counts.mean()) < 1.5
    out = augment.subcarrier_masking(torch.from_numpy(x), gen, mask_ratio=0.0)
    assert torch.equal(out, torch.from_numpy(x))


def test_add_noise_scale():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((64, 32, 20))
                         .astype(np.float32) * 2)
    out = augment.add_noise(x, torch.Generator().manual_seed(0), 0.05)
    assert 0.05 * 2 * 0.8 < (out - x).std().item() < 0.05 * 2 * 1.2


def test_random_scaling_bounds():
    x = torch.ones(4, 8, 20)
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(20):
        out = augment.random_scaling(x, gen)
        if torch.equal(out, x):
            seen.add("identity")
        else:
            assert 0.9 <= out.mean().item() <= 1.1
            assert torch.equal(out, out.flatten()[0].expand_as(out))
            seen.add("scaled")
    assert seen == {"identity", "scaled"}


def test_augment_batch_masks_only_whole_subcarrier_rows():
    """Draws without noise (the output differs from ``x`` in a few
    entries only, or is ``x`` times one scale) change whole subcarrier
    rows; every draw is finite, keeps the dtype, and a seed repeats it."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 540, 20)).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    kinds = {"masked": 0, "noise": 0, "identity": 0}
    for _ in range(60):
        out = augment.augment_batch(x, gen)
        assert out.shape == x.shape and out.dtype == x.dtype
        assert torch.isfinite(out).all()
        ratio = (out / x).numpy()
        scale = np.median(ratio)
        unscaled = (out / scale).numpy() if abs(scale - 1) > 1e-6 \
            else out.numpy()
        close = np.isclose(unscaled, x.numpy(), rtol=1e-5, atol=0)
        if close.mean() < 0.9:
            kinds["noise"] += 1
            continue
        rows = (~close).any(axis=2)
        assert (~close == (rows[:, :, None] & np.ones_like(close))).all()
        kinds["masked" if rows.any() else "identity"] += 1
    assert all(kinds.values()), kinds
    a = augment.augment_batch(x, torch.Generator().manual_seed(9))
    b = augment.augment_batch(x, torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
    bf = augment.augment_batch(x.to(torch.bfloat16),
                               torch.Generator().manual_seed(9))
    assert bf.dtype == torch.bfloat16
