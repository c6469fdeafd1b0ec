"""The port's MM-Fi data layer == the JAX package's, exactly, on the CPU.

``wiflow_tpu_torch/data/mmfi.py`` is a numpy copy of
``wiflow_tpu/data/mmfi.py``: the same splits (all four modes of
``decode_config``, with random_split's per-action reseed), the same
frames bit for bit (``.mat`` and ``.npy``, with inf and NaN to repair),
the same dataset items for frame and sequence units on multimodal trees
with zero-byte frames, the same dense arrays and cache behaviour from
``materialize``, the same batches from ``pad_collate``, the same val/test
split as sklearn's ``train_test_split`` (which the JAX function calls and
the port does not), and byte-identical synthetic trees.  No tolerance:
every comparison is exact (a ``.mat`` file's header holds the second it
was written, so that field alone is left out of its bytes).
"""

import copy
import os

import numpy as np
import pytest

from wiflow_tpu.data import mmfi as jax_mmfi

from wiflow_tpu_torch.data import mmfi

try:
    import cv2  # noqa: F401
    HAS_CV2 = True
except ImportError:
    HAS_CV2 = False

MODALITIES = ("wifi-csi", "rgb", "lidar", "mmwave") + (
    ("depth",) if HAS_CV2 else ())

SPLITS = {
    "random_split": {"split_to_use": "random_split",
                     "random_split": {"ratio": 0.7, "random_seed": 3}},
    "cross_scene_split": {"split_to_use": "cross_scene_split"},
    "cross_subject_split": {
        "split_to_use": "cross_subject_split",
        "cross_subject_split": {
            "train_dataset": {"subjects": ["S01", "S05", "S12"]},
            "val_dataset": {"subjects": ["S02", "S33"]}}},
    "manual_split": {
        "split_to_use": "manual_split",
        "manual_split": {
            "train_dataset": {"subjects": ["S01", "S11"],
                              "actions": ["A01", "A05"]},
            "val_dataset": {"subjects": ["S02"], "actions": ["A02"]}}},
}


@pytest.mark.parametrize("protocol", ["protocol1", "protocol2", "protocol3"])
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_decode_config_equals_jax(split, protocol):
    config = {"protocol": protocol, **SPLITS[split]}
    np.random.seed(123)
    ref = jax_mmfi.decode_config(config)
    ref_state = np.random.get_state()[1].copy()
    np.random.seed(123)
    got = mmfi.decode_config(config)
    assert got == ref
    # random_split leaves numpy's global generator where the JAX one does
    np.testing.assert_array_equal(np.random.get_state()[1], ref_state)
    assert mmfi.protocol_actions(protocol) == \
        jax_mmfi.protocol_actions(protocol)


def test_scene_of_equals_jax():
    for s in mmfi.ALL_SUBJECTS:
        assert mmfi.scene_of(s) == jax_mmfi.scene_of(s)
    for bad in ("S00", "S41"):
        with pytest.raises(ValueError):
            mmfi.scene_of(bad)
    assert mmfi.ALL_ACTIONS == jax_mmfi.ALL_ACTIONS
    assert mmfi.FRAMES_PER_SEQUENCE == jax_mmfi.FRAMES_PER_SEQUENCE == 297
    assert mmfi.MODALITY_EXTS == jax_mmfi.MODALITY_EXTS


@pytest.mark.parametrize("ext", [".mat", ".npy"])
def test_load_csi_frame_equals_jax_bit_for_bit(tmp_path, ext):
    rng = np.random.default_rng(0)
    frame = rng.standard_normal((3, 114, 10)) * 3 + 10
    frame[0, :7, 2] = np.nan
    frame[2, 5, 2] = np.inf
    frame[1, 100:, 9] = -np.inf
    frame[:, :, 4] = np.nan                # a time slice that is all NaN...
    frame[0, 0, 4] = 1.0                   # ...but one entry
    path = str(tmp_path / f"frame001{ext}")
    if ext == ".mat":
        import scipy.io as scio
        scio.savemat(path, {"CSIamp": frame})
    else:
        np.save(path, frame)
    got, ref = mmfi.load_csi_frame(path), jax_mmfi.load_csi_frame(path)
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    assert np.isfinite(got).all() and got.min() == 0 and got.max() == 1


def _tree(root, **kw):
    """The same synthetic tree, written by the JAX generator, with three
    zero-byte frames (one per modality it empties)."""
    jax_mmfi.generate_synthetic_mmfi(root, **kw)
    base = os.path.join(root, "E01", "S01", "A01")
    for mod, name in (("wifi-csi", "frame003.npy"), ("lidar", "frame005.bin"),
                      ("rgb", "frame007.npy")):
        path = os.path.join(base, mod, name)
        if os.path.exists(path):
            open(path, "wb").close()
    return root


@pytest.fixture(scope="module")
def multimodal_root(tmp_path_factory):
    return _tree(str(tmp_path_factory.mktemp("mm")),
                 subjects=("S01", "S02", "S11"), actions=("A01", "A02"),
                 frames=9, seed=4, fmt="npy", modalities=MODALITIES)


FORM = {"S01": ["A01", "A02"], "S11": ["A02"], "S02": ["A01"],
        "S05": ["A01"]}                    # S05 has no directory: skipped


def _same(a, b, where=""):
    """Exact equality of nested samples: dicts, lists, arrays, scalars."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


@pytest.mark.parametrize("modality", ["wifi-csi", "|".join(MODALITIES)])
@pytest.mark.parametrize("unit", ["frame", "sequence"])
def test_dataset_items_and_samples_equal_jax(multimodal_root, unit, modality):
    got = mmfi.MMFiDataset(multimodal_root, FORM, modality, unit)
    ref = jax_mmfi.MMFiDataset(multimodal_root, FORM, modality, unit)
    assert got.items == ref.items and len(got) == len(ref) > 0
    if unit == "frame":
        # a zero-byte frame of any requested modality drops the frame
        idx = {(i["subject"], i["action"], i["idx"]) for i in got.items}
        assert ("S01", "A01", 2) not in idx
        assert (("S01", "A01", 4) in idx) == ("lidar" not in modality)
    picks = [0, len(got) // 2, len(got) - 1]
    if unit == "sequence":
        # a sequence reads every file of its directories, the zero-byte
        # ones of S01/A01 too: both packages fail there alike
        emptied = [i for i, it in enumerate(got.items)
                   if (it["subject"], it["action"]) == ("S01", "A01")]
        for ds in (got, ref):
            with pytest.raises(EOFError):
                ds[emptied[0]]
        picks = [i for i in range(len(got)) if i not in emptied]
    samples = [got[i] for i in picks]
    _same(samples, [ref[i] for i in picks])
    _same(mmfi.pad_collate(samples),
          jax_mmfi.pad_collate([ref[i] for i in picks]))


def test_dataset_refuses_what_jax_refuses(multimodal_root):
    for kw in (dict(modality="wifi-csi|sonar"), dict(data_unit="window")):
        for module in (mmfi, jax_mmfi):
            with pytest.raises(ValueError):
                module.MMFiDataset(multimodal_root, FORM, **kw)
    seq = mmfi.MMFiDataset(multimodal_root, FORM, "wifi-csi", "sequence")
    with pytest.raises(ValueError, match="frame-unit wifi-csi"):
        seq.materialize()


def test_materialize_equals_jax_and_keeps_its_cache(multimodal_root,
                                                    tmp_path):
    config = {"protocol": "protocol3", "modality": "wifi-csi",
              **copy.deepcopy(SPLITS["manual_split"])}
    config["manual_split"]["train_dataset"]["actions"] = ["A01", "A02"]
    got_tr, got_va = mmfi.make_dataset(multimodal_root, config)
    ref_tr, ref_va = jax_mmfi.make_dataset(multimodal_root, config)
    assert got_tr.items == ref_tr.items and got_va.items == ref_va.items
    cache = str(tmp_path / "train.npz")
    csi, kp = got_tr.materialize(cache)
    rcsi, rkp = ref_tr.materialize()
    assert csi.tobytes() == rcsi.tobytes() and kp.tobytes() == rkp.tobytes()
    assert csi.shape == (len(got_tr), 3, 114, 10) and kp.shape[1:] == (17, 3)
    # a cache of the dataset's length is read back as it is...
    np.savez(cache, csi=csi + 1, kp=kp)
    again, _ = got_tr.materialize(cache)
    assert again.tobytes() == (csi + 1).tobytes()
    # ...one of another length is rebuilt and written anew
    np.savez(cache, csi=csi[:3], kp=kp[:3])
    rebuilt, _ = got_tr.materialize(cache)
    assert rebuilt.tobytes() == csi.tobytes()
    with np.load(cache) as z:
        assert z["csi"].tobytes() == csi.tobytes()


@pytest.mark.parametrize("n", [2, 3, 7, 48, 95, 1001])
def test_split_val_test_equals_sklearn(n):
    val, test = mmfi.split_val_test(n)
    rval, rtest = jax_mmfi.split_val_test(n)
    np.testing.assert_array_equal(val, rval)
    np.testing.assert_array_equal(test, rtest)
    assert sorted(np.concatenate([val, test]).tolist()) == list(range(n))


def test_split_val_test_refuses_one_item_as_sklearn_does():
    with pytest.raises(ValueError):
        jax_mmfi.split_val_test(1)
    with pytest.raises(ValueError, match="n_samples=1"):
        mmfi.split_val_test(1)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _mat_bytes(path):
    """A ``.mat`` file's bytes without the header's "Created on" time."""
    raw = open(path, "rb").read()
    head = raw[:116]
    return head[:head.index(b"Created on")], raw[116:]


@pytest.mark.parametrize("learnable", [False, True],
                         ids=["plain", "learnable"])
@pytest.mark.parametrize("fmt", ["mat", "npy"])
def test_synthetic_tree_is_byte_identical_to_jax(tmp_path, fmt, learnable):
    kw = dict(subjects=("S01", "S12"), actions=("A01", "A03"), frames=9,
              seed=5, fmt=fmt, learnable=learnable,
              modalities=("wifi-csi", "rgb", "mmwave") + (
                  ("depth",) if HAS_CV2 and not learnable else ()))
    got, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    mmfi.generate_synthetic_mmfi(got, **kw)
    jax_mmfi.generate_synthetic_mmfi(ref, **kw)
    files = _files(ref)
    assert _files(got) == files and len(files) > 4 * 9
    for f in files:
        a, b = os.path.join(got, f), os.path.join(ref, f)
        if f.endswith(".mat"):
            assert _mat_bytes(a) == _mat_bytes(b), f
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), f
