"""The port's per-joint PCK evaluators == the JAX package's, on the CPU.

``compute_pck_pckh`` (17 keypoints, scale 5-12), ``compute_pck_pckh_hpeli``
(17, scale 1-11), ``compute_pck_pckh_18`` (18, scale 6-13),
``compute_pck_pckh_15`` (15, scale 2-12 clamped at 1e-6) and the
functions ``pckh_fractions_fn`` makes, on drawn keypoints in both the
reference's coordinate-major ``[n, 2, K]`` layout and ``[n, K, 2]``,
within 1e-6 relative (``METRIC_TOL``, as ``tests/test_torch_artifacts.py``
holds ``pck_per_keypoint``: both sides compute in fp32).  Then
``eval/artifacts.py::calculate_keypoint_errors``, which now calls the
evaluators, gives the values of its earlier table of normalizers for 15
and 17 keypoints exactly (the reference's golden files are not in the
repository).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.metrics import metrics as jax_metrics

from wiflow_tpu_torch.eval import artifacts
from wiflow_tpu_torch.metrics import metrics

METRIC_TOL = 1e-6
EVALUATORS = {"compute_pck_pckh": 17, "compute_pck_pckh_hpeli": 17,
              "compute_pck_pckh_18": 18, "compute_pck_pckh_15": 15}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(k, seed, n=96, d=2):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.1, 0.9, (n, k, d)).astype(np.float32)
    dt = (gt + 0.06 * rng.standard_normal(gt.shape)).astype(np.float32)
    return dt, gt


@pytest.mark.parametrize("layout", ["coord_major", "keypoint_major"])
@pytest.mark.parametrize("thr", [0.1, 0.2, 0.5])
@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_evaluator_matches_jax(name, thr, layout):
    dt, gt = _draw(EVALUATORS[name], seed=len(name))
    if layout == "coord_major":
        dt, gt = dt.transpose(0, 2, 1), gt.transpose(0, 2, 1)
    ref = getattr(jax_metrics, name)(dt, gt, thr)
    got = getattr(metrics, name)(dt, gt, thr)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (EVALUATORS[name] + 1,)
    np.testing.assert_allclose(got, ref, rtol=METRIC_TOL, atol=METRIC_TOL)
    # torch tensors in, the same numbers out
    np.testing.assert_array_equal(
        getattr(metrics, name)(torch.from_numpy(dt), torch.from_numpy(gt),
                               thr), got)


def test_coordinate_major_is_read_as_the_reference_reads_it():
    dt, gt = _draw(17, seed=3)
    a = metrics.compute_pck_pckh(dt, gt, 0.2)
    b = metrics.compute_pck_pckh(dt.transpose(0, 2, 1),
                                 gt.transpose(0, 2, 1), 0.2)
    np.testing.assert_array_equal(a, b)
    assert 0 < a[-1] < 100


@pytest.mark.parametrize("scale,clamp", [((1, 11), None), ((2, 12), 1e-6)],
                         ids=["hpeli", "clamped"])
@pytest.mark.parametrize("d", [2, 3])
def test_pckh_fractions_fn_matches_jax(scale, clamp, d):
    dt, gt = _draw(17, seed=d, d=d)
    gt[:4, scale[1]] = gt[:4, scale[0]]        # a zero scale, clamped or not
    thresholds = (0.1, 0.2, 0.3, 0.4, 0.5)
    ref = jax_metrics.pckh_fractions_fn(*scale, clamp)(
        jnp.asarray(dt), jnp.asarray(gt), thresholds)
    got = metrics.pckh_fractions_fn(*scale, clamp)(
        torch.from_numpy(dt), torch.from_numpy(gt), thresholds)
    assert isinstance(got, torch.Tensor) and got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=METRIC_TOL, atol=METRIC_TOL)


# The normalizers ``eval/artifacts.py`` held before it called the
# evaluators: (scale_a, scale_b, clamp) by keypoint count.
EARLIER_SCALES = {15: (2, 12, 1e-6), 17: (5, 12, None)}


@pytest.mark.parametrize("k,d", [(15, 2), (17, 3)])
def test_keypoint_errors_keep_their_values(k, d):
    pred, true = _draw(k, seed=k, n=300, d=d)
    rows = artifacts.calculate_keypoint_errors(true, pred)
    a, b, clamp = EARLIER_SCALES[k]
    for thr, key in ((0.2, "pck@0.2"), (0.5, "pck@0.5")):
        earlier = metrics.pck_per_keypoint(
            torch.from_numpy(pred[..., :2]), torch.from_numpy(true[..., :2]),
            thr, a, b, clamp).numpy()[:k]
        assert [r[key] for r in rows] == [float(v) for v in earlier]
    assert len(rows) == k and all(r["mean_error"] > 0 for r in rows)
