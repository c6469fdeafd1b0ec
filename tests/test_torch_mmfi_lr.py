"""Why the MM-Fi trainer serves a flat output at the default lr: the recipe.

The JAX package's ``train_pose_model`` and the port's train the full-width
MM-Fi model (fp32) from the same initial weights, carried across with
``state_dict_from_jax``, on one small learnable ``generate_synthetic_mmfi``
tree (4 subjects x 2 actions x 48 frames: 240 train, 72 val, 72 test
frames) with the MM-Fi CLI's recipe at its default lr (1e-4, AdamW, weight
decay 1e-4, batch 16, the MM-Fi skeleton, root-relative PCK, val-PCK
monitor) for 3 epochs.  Each serves its best weights on the test split;
the spread of the output (its std over the frames, averaged over the
outputs) is taken as a share of max|output|, the 1/100 bar of
``chip_smoke.py``'s MM-Fi phase.

Both stay far under the bar and within a factor 2 of each other: the flat
output comes from the recipe (the JAX package's too), not from the port.
"""

import numpy as np
import pytest
import torch

BAR = 1e-2
EPOCHS, BATCH, LR = 3, 16, 1e-4


def _spread(out):
    out = np.asarray(out, np.float64)
    return out.std(axis=0).mean() / np.abs(out).max()


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    from wiflow_tpu_torch.data.mmfi import (
        generate_synthetic_mmfi, make_dataset, split_val_test,
    )
    root = str(tmp_path_factory.mktemp("mmfi") / "tree")
    generate_synthetic_mmfi(root, subjects=("S01", "S02", "S03", "S11"),
                            actions=("A01", "A02"), frames=48, seed=1,
                            fmt="npy", learnable=True)
    train, val = make_dataset(root, {
        "modality": "wifi-csi", "protocol": "protocol3",
        "split_to_use": "random_split",
        "random_split": {"ratio": 0.7, "random_seed": 0}})
    val_all = val.materialize()
    vi, ti = split_val_test(len(val))
    return (train.materialize(), (val_all[0][vi], val_all[1][vi]),
            (val_all[0][ti], val_all[1][ti]))


def test_default_lr_flatness_is_the_recipes(splits, tmp_path):
    import jax
    import jax.numpy as jnp
    from wiflow_tpu.core import config as jc
    from wiflow_tpu.metrics import mmfi_metrics as jm
    from wiflow_tpu.models.wiflow_mmfi import MMFiModelConfig as JaxConfig
    from wiflow_tpu.models.wiflow_mmfi import WiFlowMMFiModel as JaxModel
    from wiflow_tpu.train.loop import train_pose_model as jax_train

    from wiflow_tpu_torch.core.config import (
        MMFI_SKELETON_CONNECTIONS, Config, OptimConfig, TrainConfig,
    )
    from wiflow_tpu_torch.metrics.mmfi_metrics import (
        root_aligned_mpjpe, root_relative_pck_fractions,
    )
    from wiflow_tpu_torch.models.torch_compat import state_dict_from_jax
    from wiflow_tpu_torch.models.wiflow_mmfi import (
        MMFiModelConfig, WiFlowMMFiModel,
    )
    from wiflow_tpu_torch.train.loop import train_pose_model

    train, val, test = splits
    jmodel = JaxModel(JaxConfig(compute_dtype="float32"))
    v = jax.tree.map(np.asarray, jax.jit(
        lambda k, x: jmodel.init({"params": k}, x, train=False))(
            jax.random.key(0), jnp.zeros((1, 3, 114, 10))))

    jcfg = jc.Config(
        train=jc.TrainConfig(batch_size=BATCH, num_epochs=EPOCHS, seed=3,
                             optim=jc.OptimConfig(lr=LR, weight_decay=1e-4)),
        mesh=jc.MeshConfig(num_devices=1))
    rj = jax_train(train, val, test, jcfg, str(tmp_path / "jax"),
                   model=jmodel, init_variables=v,
                   connections=jc.MMFI_SKELETON_CONNECTIONS,
                   pck_fn=jm.root_relative_pck_fractions,
                   mpe_fn=jm.root_aligned_mpjpe, monitor="pck",
                   verbose=False)
    jax_spread = _spread(jmodel.apply(rj.variables, jnp.asarray(test[0]),
                                      train=False))

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pcfg = MMFiModelConfig(compute_dtype="float32")
        model = WiFlowMMFiModel(pcfg, device="cpu")
        cfg = Config(train=TrainConfig(
            batch_size=BATCH, num_epochs=EPOCHS, seed=3,
            optim=OptimConfig(lr=LR, weight_decay=1e-4)))
        rp = train_pose_model(train, val, test, cfg, None, model=model,
                              init_state_dict=state_dict_from_jax(v, pcfg),
                              connections=MMFI_SKELETON_CONNECTIONS,
                              pck_fn=root_relative_pck_fractions,
                              mpe_fn=root_aligned_mpjpe, monitor="pck",
                              verbose=False)
        model.load_state_dict(rp.state_dict)
        model.eval()
        with torch.no_grad():
            port_spread = _spread(model(torch.from_numpy(test[0])))
    finally:
        torch.set_num_threads(threads)

    print(f"served spread / max|output|: JAX {jax_spread:.3e}, "
          f"port {port_spread:.3e} (bar {BAR:g})")
    assert len(rj.history["val_pck"]) == len(rp.history["val_pck"]) == EPOCHS
    assert jax_spread < BAR and port_spread < BAR
    assert 0.5 < port_spread / jax_spread < 2.0
